"""Seeded fault injection for the sweep fleet and the serving loop: the
twin of ``repro/streaming/chaos.py``.

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
stale), ``after_publish(out_dir)`` from a sweep worker once its result is
published (drop: delete it, so the launcher sees a worker that exited with
no result), ``query_delay(req_id)`` (seeded added latency, accounted by the
query path and never slept) and ``mangle_candidate`` (NaN or blow-up of a
re-solve's candidate before the serving gate). One-shot faults write a
marker under the state directory and a ``chaos_fired`` journal record
BEFORE they fire, so a relaunched process does not fire them again and the
firing is attributable. Every draw is numpy's (``default_rng`` keyed by
plan seed, fault index and request id), so the port's boundaries and
delays are the reference's. A sweep worker gets its hooks from
``hooks_from_env``: inert unless ``REPRO_CHAOS_PLAN`` names a plan.

Network faults have their own document (``validate_net_fault_doc``,
``net_fault_model_from_dict``, ``REPRO_NET_FAULTS``): link drops, bursts,
crash windows and payload corruption inside the gossip, through
``core.netfaults.FaultyConsensus``.

    python -m repro_torch.streaming.chaos --validate plan.json
    python -m repro_torch.streaming.chaos --smoke [--device cpu]

``--smoke`` runs ``run_smoke``: a small pinned grid under one fault of each
sweep kind (kill, corrupt-newest, slow, drop) must merge bit for bit equal
to the fault-free sweep, with the reference's attempt counts.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import time
from typing import List, Optional

import numpy as np

from ..obs import get_journal

__all__ = ["FaultPlan", "ChaosHooks", "ENV_PLAN", "ENV_NET",
           "hooks_from_env", "validate_net_fault_doc",
           "net_fault_model_from_dict", "net_faults_from_env",
           "validate_plan_file", "smoke_plan", "run_smoke", "main"]

ENV_PLAN = "REPRO_CHAOS_PLAN"
ENV_NET = "REPRO_NET_FAULTS"
_STATE_DIR = "chaos_state"

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

    def after_publish(self, out_dir: str) -> None:
        """Fire a ``drop`` fault: delete the result just published, once.
        The worker still exits 0; the launcher retries the shard."""
        if self.plan is None:
            return
        for idx, fault in enumerate(self.plan.faults):
            if (fault["kind"] == "drop"
                    and _matches(fault, self.shard, self.worker)
                    and not self._fired(idx)):
                self._mark(idx)
                self._journal(idx, "drop", out_dir=out_dir)
                shutil.rmtree(out_dir, ignore_errors=True)

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


def hooks_from_env(*, shard=None, worker=None, n_boundaries: int = 1,
                   ckpt_root: Optional[str] = None,
                   workdir: Optional[str] = None,
                   step_boundaries: bool = False) -> ChaosHooks:
    """The worker's one chaos entry point: inert hooks unless
    ``REPRO_CHAOS_PLAN`` names a plan file, so the production path never
    branches on chaos. One-shot markers go under ``<workdir>/chaos_state``
    (default: beside the plan)."""
    path = os.environ.get(ENV_PLAN)
    if not path:
        return ChaosHooks(None)
    plan = FaultPlan.load(path)
    state_dir = os.path.join(workdir or os.path.dirname(path), _STATE_DIR)
    return ChaosHooks(plan, shard=shard, worker=worker,
                      n_boundaries=n_boundaries, ckpt_root=ckpt_root,
                      state_dir=state_dir, step_boundaries=step_boundaries)


# ---------------------------------------------------------------------------
# network-fault plans (the gossip's twin of FaultPlan)
# ---------------------------------------------------------------------------
# FaultPlan injects process faults; REPRO_NET_FAULTS injects network faults
# into the gossip itself (link drops, Gilbert-Elliott bursts, node crash and
# rejoin, payload corruption) through core.netfaults.FaultyConsensus. The
# same conventions: a small seeded JSON document, through an env var:
#
#     {"seed": 0, "p_drop": 0.2,
#      "burst": {"p_bad": 0.05, "p_good": 0.5},
#      "corrupt": {"p": 0.01, "mode": "scale", "scale": 1e9, "guard": 1e6},
#      "crash": [{"node": 0, "start": 2, "len": 3}],
#      "debias": "realized"}
#
# Every field is optional (an empty document is the fault-free model).

def _num_field(doc, key, lo=None, hi=None, path=""):
    v = doc[key]
    label = f"{path}{key}"
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        raise ValueError(f"{label}: expected a number, got {v!r}")
    v = float(v)
    if lo is not None and v < lo or hi is not None and v > hi:
        rng = (f"[{lo}, {hi}]" if hi is not None else f">= {lo}")
        raise ValueError(f"{label}: must be in {rng}, got {v}")
    return v


def validate_net_fault_doc(doc: dict) -> dict:
    """Validate a net-fault JSON document, raising ``ValueError`` with a
    field-path diagnostic (``crash[1].len: must be a positive integer``)
    on the first malformed field. Returns the parsed document unchanged."""
    if not isinstance(doc, dict):
        raise ValueError(f"net-fault plan: expected a JSON object, got "
                         f"{type(doc).__name__}")
    known = {"seed", "p_drop", "burst", "corrupt", "crash", "debias"}
    for k in doc:
        if k not in known:
            raise ValueError(f"{k}: unknown field (expected one of "
                             f"{sorted(known)})")
    if "seed" in doc and not isinstance(doc["seed"], int):
        raise ValueError(f"seed: expected an integer, got {doc['seed']!r}")
    if "p_drop" in doc:
        _num_field(doc, "p_drop", 0.0, 1.0)
    if "burst" in doc:
        burst = doc["burst"]
        if not isinstance(burst, dict):
            raise ValueError(f"burst: expected an object, got {burst!r}")
        for k in burst:
            if k not in ("p_bad", "p_good"):
                raise ValueError(f"burst.{k}: unknown field")
            _num_field(burst, k, 0.0, 1.0, path="burst.")
        if burst.get("p_bad", 0.0) > 0.0 and burst.get("p_good", 1.0) <= 0.0:
            raise ValueError("burst.p_good: must be > 0 when burst.p_bad "
                             "> 0 (a burst must be able to end)")
    if "corrupt" in doc:
        cor = doc["corrupt"]
        if not isinstance(cor, dict):
            raise ValueError(f"corrupt: expected an object, got {cor!r}")
        for k in cor:
            if k not in ("p", "mode", "scale", "guard"):
                raise ValueError(f"corrupt.{k}: unknown field")
        if "p" in cor:
            _num_field(cor, "p", 0.0, 1.0, path="corrupt.")
        if cor.get("mode", "scale") not in ("scale", "nan"):
            raise ValueError(f"corrupt.mode: expected 'scale' or 'nan', "
                             f"got {cor.get('mode')!r}")
        for k in ("scale", "guard"):
            if k in cor and _num_field(cor, k, path="corrupt.") <= 0.0:
                raise ValueError(f"corrupt.{k}: must be > 0")
    if "crash" in doc:
        crash = doc["crash"]
        if not isinstance(crash, list):
            raise ValueError(f"crash: expected a list, got {crash!r}")
        for i, win in enumerate(crash):
            if not isinstance(win, dict):
                raise ValueError(f"crash[{i}]: expected an object")
            for k in ("node", "start", "len"):
                if k not in win:
                    raise ValueError(f"crash[{i}].{k}: missing")
                if not isinstance(win[k], int) or isinstance(win[k], bool):
                    raise ValueError(f"crash[{i}].{k}: expected an integer,"
                                     f" got {win[k]!r}")
            if win["node"] < 0:
                raise ValueError(f"crash[{i}].node: must be >= 0")
            if win["start"] < 0:
                raise ValueError(f"crash[{i}].start: must be >= 0")
            if win["len"] <= 0:
                raise ValueError(f"crash[{i}].len: must be a positive "
                                 "integer")
    if doc.get("debias", "realized") not in ("realized", "nominal"):
        raise ValueError(f"debias: expected 'realized' or 'nominal', got "
                         f"{doc.get('debias')!r}")
    return doc


def net_fault_model_from_dict(doc: dict):
    """Build the ``core.netfaults.NetFaultModel`` a validated document
    describes. Returns ``(model, seed, debias)``: what a worker needs to
    wrap each case engine in a ``FaultyConsensus`` (the model is imported
    here, so validating a document needs none of the gossip code)."""
    from ..core.netfaults import NetFaultModel

    validate_net_fault_doc(doc)
    burst = doc.get("burst", {})
    cor = doc.get("corrupt", {})
    model = NetFaultModel(
        p_drop=float(doc.get("p_drop", 0.0)),
        p_bad=float(burst.get("p_bad", 0.0)),
        p_good=float(burst.get("p_good", 1.0)),
        p_corrupt=float(cor.get("p", 0.0)),
        corrupt_mode=cor.get("mode", "scale"),
        corrupt_scale=float(cor.get("scale", 1e9)),
        guard_norm=float(cor.get("guard", 1e6)),
        crash_windows=tuple((int(w["node"]), int(w["start"]), int(w["len"]))
                            for w in doc.get("crash", ())),
    )
    return model, int(doc.get("seed", 0)), doc.get("debias", "realized")


def net_faults_from_env() -> Optional[dict]:
    """The launcher's net-fault entry point: ``REPRO_NET_FAULTS`` names a
    plan file (or holds inline JSON, for one-liners); absent -> None and
    the production path never branches on faults."""
    spec = os.environ.get(ENV_NET)
    if not spec:
        return None
    if spec.lstrip().startswith("{"):
        doc = json.loads(spec)
    else:
        with open(spec) as f:
            doc = json.load(f)
    return validate_net_fault_doc(doc)


def validate_plan_file(path: str, verbose: bool = True) -> int:
    """``--validate`` mode: check a chaos/net-fault plan file, printing a
    line/field diagnostic for malformed plans. Auto-detects the plan kind
    (a ``"faults"`` key -> process FaultPlan, else net-fault document).
    Returns a process exit code (0 valid, 1 invalid)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        print(f"{path}: unreadable: {e}")
        return 1
    except json.JSONDecodeError as e:
        print(f"{path}:{e.lineno}:{e.colno}: invalid JSON: {e.msg}")
        return 1
    try:
        if isinstance(doc, dict) and "faults" in doc:
            FaultPlan(doc.get("faults", []), seed=doc.get("seed", 0))
            kind = f"process fault plan ({len(doc.get('faults', []))} faults)"
        else:
            validate_net_fault_doc(doc)
            kind = "net-fault plan"
    except (ValueError, TypeError) as e:
        print(f"{path}: invalid: {e}")
        return 1
    if verbose:
        print(f"{path}: valid {kind}")
    return 0


# ---------------------------------------------------------------------------
# the seeded chaos-smoke scenario
# ---------------------------------------------------------------------------
def smoke_plan(seed: int = 0) -> FaultPlan:
    """One fault of each sweep kind over four shards: a SIGKILL at a seeded
    chunk boundary (shard 0), the newest checkpoint torn and a SIGKILL at
    boundary 3 (shard 1: steps 2 and 4 are on disk, so the relaunch falls
    back to step 2), a straggler (shard 2) and a dropped publish
    (shard 3)."""
    return FaultPlan(seed=seed, faults=[
        {"kind": "kill", "shard": 0},
        {"kind": "corrupt", "shard": 1, "mode": "truncate", "boundary": 3},
        {"kind": "slow", "shard": 2, "sleep": 0.2},
        {"kind": "drop", "shard": 3},
    ])


def run_smoke(workdir: str, *, seed: int = 0, verbose: bool = True,
              n_workers: int = 4, device=None) -> dict:
    """The chaos-equivalence scenario: a small pinned grid (d = 16, r = 3, 6
    nodes, 4 seeds in 4 shards, T_o = 8 in chunks of 2) under
    ``smoke_plan`` must complete through retries and merge bit for bit
    equal to the fault-free sweep run shard by shard in this process, with
    the reference's attempt counts (2, 2, 1, 2) and shard 1 resumed from
    step 2. ``n_workers`` bounds the processes alive at once; ``device``
    is the card unless it says ``cpu``. Returns a summary; raises on a
    mismatch."""
    import numpy as np
    import torch

    from .._device import resolve_device
    from ..core.linalg import eigh_topr
    from ..core.sweep import sdot_sweep, slice_seed_shards
    from ..data.pipeline import eigengap_stream
    from .ingest import StreamingIngestor
    from .launcher import build_engine, build_schedule, launch_sweep

    dev = resolve_device(device)
    d, r, n_nodes, t_outer, t_c = 16, 3, 6, 8, 10
    seeds = list(range(4))
    batch_fn, _, _ = eigengap_stream(d, r, 0.7, seed=seed, device=dev)
    ing = StreamingIngestor(n_nodes=n_nodes, d=d, batch_fn=batch_fn,
                            batch_size=30, device=dev)
    ing.ingest(10)
    covs = ing.cov_stack()
    _, q_true = eigh_topr(covs.sum(0), r)
    cases = [{"topology": {"kind": "er", "n": n_nodes, "p": 0.5, "seed": 1},
              "schedule": {"kind": "lin2", "cap": t_c}}]
    plan = smoke_plan(seed)
    t0 = time.perf_counter()
    sw = launch_sweep(covs=covs, cases=cases, r=r, t_outer=t_outer, t_c=t_c,
                      seeds=seeds, q_true=q_true, workdir=workdir,
                      n_workers=n_workers, n_shards=4, sweep_chunk=2,
                      retries=2, chaos_plan=plan, timeout=600.0, device=dev)
    chaos_s = time.perf_counter() - t0

    # the fault-free sweep at matching lane widths: each shard's seeds in
    # this process, so equality is bitwise
    engines = [build_engine(c["topology"], device=dev) for c in cases]
    schedules = [build_schedule(c["schedule"], t_outer, t_c) for c in cases]
    parts = [sdot_sweep(covs=covs, engines=engines, schedules=schedules,
                        r=r, t_outer=t_outer, t_c=t_c, seeds=s,
                        q_true=q_true, device=dev)
             for s in slice_seed_shards(seeds, 4)]
    np.testing.assert_array_equal(
        np.asarray(sw.error_traces),
        np.concatenate([p.error_traces for p in parts], axis=0))
    assert torch.equal(sw.q, torch.cat([p.q.cpu() for p in parts]))
    assert list(sw.seeds) == seeds
    ref_ledger = parts[0].ledger
    for p in parts[1:]:
        ref_ledger = ref_ledger.merged(p.ledger)
    assert sw.ledger.p2p == ref_ledger.p2p
    assert sw.ledger.scalars == ref_ledger.scalars

    rep = sw.resume_report or {}
    # the recovery paths are part of the result: kill, corrupt and drop
    # each took a retry, and the torn shard-1 checkpoint fell back to 2
    assert rep["attempts"] == {0: 2, 1: 2, 2: 1, 3: 2}, rep
    assert rep["worker_resumed_steps"][1] == 2, rep
    summary = {
        "chaos_sweep_s": round(chaos_s, 3),
        "faults": [f["kind"] for f in plan.faults],
        "attempts": rep.get("attempts"),
        "worker_resumed_steps": rep.get("worker_resumed_steps"),
        "device": dev.type,
        "bitwise_equal": True,
    }
    if verbose:
        print(json.dumps(summary, indent=2))
    return summary


def main(argv=None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="run the seeded chaos-equivalence scenario")
    ap.add_argument("--validate", metavar="PLAN",
                    help="check a chaos / net-fault plan file and exit "
                         "(prints a line / field diagnostic when malformed)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=4,
                    help="worker processes alive at once (smoke)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (smoke)")
    args = ap.parse_args(argv)
    if args.validate:
        return validate_plan_file(args.validate)
    if not args.smoke:
        ap.error("nothing to do (pass --smoke or --validate)")
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_smoke_")
    run_smoke(workdir, seed=args.seed, n_workers=args.workers,
              device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
