"""Seeded fault injection: the part of ``repro/streaming/chaos.py`` the
serving loop uses.

A ``FaultPlan`` is a small, seeded, declarative JSON document (the
reference's format, so one plan file drives both packages):

    {"seed": 0, "faults": [
        {"kind": "kill",    "worker": "service", "boundary": 7},
        {"kind": "corrupt", "shard": 1, "mode": "truncate"},
        {"kind": "slow",    "worker": 0, "factor": 10.0},
        {"kind": "hang",    "worker": "service", "boundary": 12,
         "sleep": 60},
        {"kind": "drop",    "shard": 4},
        {"kind": "delay_query", "p": 0.4, "delay": 0.5},
        {"kind": "corrupt_candidate", "mode": "nan", "resolve": 1}]}

``ChaosHooks`` fires it: ``at_boundary(step)`` from a checkpoint manager's
``on_save`` (kill: a real SIGKILL; corrupt: tear the newest step, then
SIGKILL; slow: sleep; hang: sleep without exiting, so the heartbeat goes
stale), ``query_delay(req_id)`` (seeded added
latency, accounted by the query path and never slept) and
``mangle_candidate`` (NaN or blow-up of a re-solve's candidate before the
serving gate). One-shot faults write a marker under the state directory
and a ``chaos_fired`` journal record BEFORE they fire, so a relaunched
process does not fire them again and the firing is attributable. Every
draw is numpy's (``default_rng`` keyed by plan seed, fault index and
request id), so the port's boundaries and delays are the reference's.
``drop`` validates in a plan but fires only from the sweep fleet's
``after_publish``, which is not ported yet, nor are ``hooks_from_env``,
the net-fault document validators and the chaos smoke run.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import List, Optional

import numpy as np

from ..obs import get_journal

__all__ = ["FaultPlan", "ChaosHooks", "ENV_PLAN"]

ENV_PLAN = "REPRO_CHAOS_PLAN"

_KINDS = ("kill", "corrupt", "slow", "hang", "drop", "delay_query",
          "corrupt_candidate")


class FaultPlan:
    """Declarative, seeded fault schedule (see module docstring)."""

    def __init__(self, faults: List[dict], seed: int = 0):
        for i, f in enumerate(faults):
            kind = f.get("kind")
            if kind not in _KINDS:
                raise ValueError(f"fault {i}: unknown kind {kind!r}"
                                 f" (expected one of {_KINDS})")
            if kind == "delay_query":
                p = f.get("p", 1.0)
                if not isinstance(p, (int, float)) or isinstance(p, bool) \
                        or not 0.0 <= float(p) <= 1.0:
                    raise ValueError(f"fault {i}: delay_query.p must be a "
                                     f"number in [0, 1], got {p!r}")
                delay = f.get("delay", 0.05)
                if not isinstance(delay, (int, float)) \
                        or isinstance(delay, bool) or float(delay) < 0.0:
                    raise ValueError(f"fault {i}: delay_query.delay must be "
                                     f"a number >= 0 (seconds), got {delay!r}")
            if kind == "corrupt_candidate" \
                    and f.get("mode", "nan") not in ("nan", "scale"):
                raise ValueError(f"fault {i}: corrupt_candidate.mode must be "
                                 f"'nan' or 'scale', got {f.get('mode')!r}")
        self.faults = list(faults)
        self.seed = int(seed)

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            doc = json.load(f)
        return cls(doc.get("faults", []), seed=doc.get("seed", 0))

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump({"seed": self.seed, "faults": self.faults}, f,
                      indent=2)
        return path

    def boundary_for(self, fault_idx: int, n_boundaries: int) -> int:
        """The 1-indexed chunk boundary at which fault ``fault_idx`` fires.

        Deterministic in (plan seed, fault index): the same plan replayed
        against the same grid kills/corrupts at the same boundary, so chaos
        runs are reproducible end to end."""
        fault = self.faults[fault_idx]
        if fault.get("boundary") is not None:
            return int(fault["boundary"])
        rng = np.random.default_rng(self.seed * 7919 + fault_idx)
        return int(rng.integers(1, max(2, n_boundaries + 1)))


def _matches(fault: dict, shard: Optional[int], worker: Optional[str]) -> bool:
    """A fault applies when every target it names matches this process.

    ``shard`` targets the work item (kill/corrupt/drop travel with the
    shard's state); ``worker`` targets the process identity — ``"w<k>"`` for
    fleet workers, the shard index for pinned workers — which is the right
    axis for the straggler model (a slow *machine*, whatever it runs)."""
    if "shard" in fault and (shard is None or int(fault["shard"]) != shard):
        return False
    if "worker" in fault:
        want = str(fault["worker"])
        have = "" if worker is None else str(worker)
        if want != have and f"w{want}" != have:
            return False
    return True


class ChaosHooks:
    """Per-process injection hooks; a no-op shell when ``plan`` is None.

    ``at_boundary(step)`` is invoked from the checkpoint manager's
    ``on_save`` callback (every chunk boundary); ``query_delay(req_id)``
    from a serving query path per admitted request; ``mangle_candidate``
    from the serving quality gate on each re-solve candidate.

    ``step_boundaries=True`` anchors boundary matching to the SAVED STEP
    NUMBER instead of this process's save count: a long-lived service whose
    step counter survives restarts (the serving tick) wants fault
    boundaries pinned to absolute ticks, so a plan reads the same before
    and after a crash — a worker's per-attempt count restarts from zero,
    which is the right axis for the sweep fleet but not for a service.
    """

    def __init__(self, plan: Optional[FaultPlan], *, shard=None, worker=None,
                 n_boundaries: int = 1, ckpt_root: Optional[str] = None,
                 state_dir: Optional[str] = None,
                 step_boundaries: bool = False):
        self.plan = plan
        self.shard = None if shard is None else int(shard)
        self.worker = None if worker is None else str(worker)
        self.n_boundaries = max(1, int(n_boundaries))
        self.ckpt_root = ckpt_root
        self.state_dir = state_dir
        self.step_boundaries = bool(step_boundaries)
        self._boundary = 0
        self._last_t = time.monotonic()
        if plan is not None and state_dir:
            os.makedirs(state_dir, exist_ok=True)

    @property
    def active(self) -> bool:
        return self.plan is not None

    # -- one-shot bookkeeping -------------------------------------------
    def _marker(self, idx: int) -> str:
        tag = f"fired_{idx}" + ("" if self.shard is None
                                else f"_s{self.shard}")
        return os.path.join(self.state_dir or ".", tag)

    def _fired(self, idx: int) -> bool:
        return os.path.exists(self._marker(idx))

    def _mark(self, idx: int) -> None:
        # the marker lands BEFORE the fault executes: a SIGKILL mid-fault
        # must not re-arm it on relaunch
        with open(self._marker(idx), "w") as f:
            f.write(str(time.time()))
            f.flush()
            os.fsync(f.fileno())

    def _journal(self, idx: int, kind: str, **fields) -> None:
        # also BEFORE the fault executes: the journal append is one atomic
        # os.write, so even a self-SIGKILL on the next line leaves the
        # firing attributable from the trace (the forensics CLI matches
        # these records against the plan by fault index)
        # "kind" is reserved record schema (event/span_start/span), so the
        # fault's kind travels as fault_kind
        get_journal().event("chaos_fired", "chaos", fault=idx,
                            fault_kind=kind, boundary=self._boundary,
                            shard=self.shard, worker=self.worker, **fields)

    # -- fault executors -------------------------------------------------
    def _corrupt_newest(self, mode: str) -> None:
        root = self.ckpt_root
        if not root or not os.path.isdir(root):
            return
        steps = sorted(n for n in os.listdir(root)
                       if n.startswith("step_") and ".tmp" not in n)
        if not steps:
            return
        newest = os.path.join(root, steps[-1])
        shard_file = os.path.join(newest, "shards.npz")
        if mode == "manifest":
            os.remove(os.path.join(newest, "manifest.json"))
        elif mode == "truncate" and os.path.exists(shard_file):
            size = os.path.getsize(shard_file)
            with open(shard_file, "r+b") as f:
                f.truncate(size // 2)
        else:  # "garbage"
            with open(shard_file, "wb") as f:
                f.write(b"chaos: not an npz")

    # -- hook entry points -----------------------------------------------
    def at_boundary(self, step: int) -> None:
        if self.plan is None:
            return
        if self.step_boundaries:
            self._boundary = int(step)
        else:
            self._boundary += 1
        elapsed = time.monotonic() - self._last_t
        self._last_t = time.monotonic()
        for idx, fault in enumerate(self.plan.faults):
            if not _matches(fault, self.shard, self.worker):
                continue
            kind = fault["kind"]
            if kind in ("delay_query", "corrupt_candidate"):
                continue  # fire from the serving hooks, not at boundaries
            if kind == "slow":
                if "sleep" in fault:
                    pause = float(fault["sleep"])
                else:
                    pause = max(0.0, (float(fault.get("factor", 2.0))
                                      - 1.0) * elapsed)
                self._journal(idx, kind, sleep_s=round(pause, 6))
                time.sleep(pause)
                continue
            if kind == "drop":
                continue  # fires at publish time
            if self._boundary != self.plan.boundary_for(
                    idx, self.n_boundaries) or self._fired(idx):
                continue
            self._mark(idx)
            self._journal(idx, kind, step=step)
            if kind == "hang":
                time.sleep(float(fault.get("sleep", 600.0)))
            elif kind == "corrupt":
                self._corrupt_newest(fault.get("mode", "garbage"))
                os.kill(os.getpid(), signal.SIGKILL)
            elif kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)

    def query_delay(self, req_id: int) -> float:
        """Seconds of injected latency for request ``req_id`` (0.0 inert).

        Deterministic in (plan seed, fault index, req_id): the same plan
        delays the same requests on every run, so deadline-expiry and
        load-shedding behaviour is reproducible. The caller adds the delay
        to its service time (sleep or simulated clock)."""
        if self.plan is None:
            return 0.0
        total = 0.0
        for idx, fault in enumerate(self.plan.faults):
            if fault["kind"] != "delay_query" \
                    or not _matches(fault, self.shard, self.worker):
                continue
            rng = np.random.default_rng(
                self.plan.seed * 7919 + (idx + 1) * 104729 + int(req_id))
            if rng.random() < float(fault.get("p", 1.0)):
                delay = float(fault.get("delay", 0.05))
                self._journal(idx, "delay_query", req_id=int(req_id),
                              delay_s=delay)
                total += delay
        return total

    def mangle_candidate(self, q, resolve_id: int):
        """One-shot corruption of a re-solve candidate before the gate.

        ``mode`` "nan" poisons one entry; "scale" blows the candidate up by
        ``scale`` (default 1e9, destroying orthonormality). An optional
        ``"resolve"`` field pins the fault to one re-solve id; without it
        the first candidate to pass through is hit. Returns the (possibly
        corrupted) candidate."""
        if self.plan is None:
            return q
        for idx, fault in enumerate(self.plan.faults):
            if fault["kind"] != "corrupt_candidate" \
                    or not _matches(fault, self.shard, self.worker) \
                    or self._fired(idx):
                continue
            if fault.get("resolve") is not None \
                    and int(fault["resolve"]) != int(resolve_id):
                continue
            self._mark(idx)
            self._journal(idx, "corrupt_candidate",
                          resolve=int(resolve_id),
                          mode=fault.get("mode", "nan"))
            arr = np.array(q, np.float32, copy=True)
            if fault.get("mode", "nan") == "nan":
                arr.flat[0] = np.nan
            else:
                arr *= float(fault.get("scale", 1e9))
            q = arr
        return q
