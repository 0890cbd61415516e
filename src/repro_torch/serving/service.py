"""Always-fresh subspace serving: the crash-resumable PSA service loop.

The twin of ``repro/serving/service.py``. The paper solves one principal
subspace problem; a deployment serves the subspace of a stream whose
population changes under it. ``PSAService`` runs a sequence of
deterministic *ticks*:

    ingest -> drift detect -> (warm re-solve, a few chunks) -> quality gate
           -> atomic swap -> answer queries -> checkpoint

* **Ingest**: one micro-batch a tick into a ``StreamingIngestor``
  (``track_top=r``), drawn on the device; its Ritz track feeds the drift
  detector.
* **Drift -> warm re-solve**: when ``drift.DriftDetector`` triggers, the
  service freezes the current cov stack (kept on the device) and starts an
  S-DOT re-solve warm-started from the served subspace, advanced a few
  chunks a tick through ``core.runtime.run_chunked(..., target_step=...)``.
  The re-solve's RunState lives in its own checkpoint directory and each
  tick's target is an absolute step, so a kill at any chunk boundary
  resumes with the same bits and a re-executed tick never advances the
  solve twice. Every CholeskyQR2 of the re-solve, and the candidate's,
  runs through the Gram kernel (``kernels/ops.gram_qr``).
* **Quality gate -> atomic swap**: a finished candidate must be finite,
  orthonormal and explain at least the incumbent's variance on a held-out
  batch (numpy draws keyed by the stream step, the reference's). Pass: one
  assignment publishes the host copy and the card copy of the new subspace
  together (``Served``), and the tick's snapshot is pinned so retention
  never removes the last-good served subspace. Fail: the candidate is
  never served, the reject is counted and a cold re-solve starts.
* **Queries**: ``query.QueryPath`` against the card copy.
* **Checkpoint**: the whole service state (sketch and Ritz track, served
  subspace, re-solve bookkeeping and its frozen covs, counters) is one
  tree under the reference's leaf names, saved at every tick. The device
  state goes to the host only for this snapshot. A SIGKILL anywhere
  re-executes at most one tick, and the served trajectory (swap ticks and
  served bits) equals the uninterrupted run's on the same device.

The stream's samples, the first served Q, the Ritz init and each cold
re-solve's Q_init are the port's own torch draws; ``ServiceDraws`` injects
the reference's instead (the parity tests). A snapshot names a position in
one stream, so the state directory records whose stream it is
(``stream.json``), and a directory of snapshots without it (the JAX
reference service's) or with another stream or device is refused.

``run_supervised`` runs the loop in a subprocess under a heartbeat
watchdog and relaunches it with backoff; ``run_smoke`` is the seeded
scenario: fault-free, then kill / kill / hang under supervision (the same
served bits), then a corrupt candidate and delayed queries in-process.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
import zipfile
from typing import Callable, Optional

import numpy as np
import torch

from .. import _tree
from .._device import DeviceLike, resolve_device
from ..checkpoint.manager import CheckpointManager
from ..core.linalg import cholesky_qr2, orthonormal_init
from ..core.metrics import subspace_error
from ..core.runtime import run_chunked
from ..core.sdot import sdot_program
from ..data.pipeline import drifting_eigengap_stream
from ..obs import install as obs_install
from ..obs import metrics as obs_metrics
from ..obs import obs_dir_for
from ..streaming.chaos import ENV_PLAN, ChaosHooks, FaultPlan
from ..streaming.ingest import StreamingIngestor
from ..streaming.launcher import build_engine
from .drift import DriftDetector
from .query import QueryPath

__all__ = ["ServiceConfig", "ServiceDraws", "Served", "PSAService",
           "run_supervised", "run_smoke", "smoke_plan", "gate_plan",
           "service_summary", "main"]

_STATE = "state"          # <workdir>/state: per-tick service snapshots
_RESOLVE = "resolve"      # <workdir>/resolve: active re-solve RunState
_STREAM = "stream.json"   # <workdir>/state/stream.json: whose stream
_EVENTS = "events.jsonl"
_FINAL = "final.json"
_HEARTBEAT = "heartbeat"
_RESTORE_ERRORS = (OSError, ValueError, KeyError, EOFError,
                   zipfile.BadZipFile)


@dataclasses.dataclass
class ServiceConfig:
    """Everything a service run needs, JSON-round-trippable for the
    supervisor's subprocess handoff (the reference's fields and defaults).
    The drifting stream is part of the config, so a relaunched process
    rebuilds the same (seed, step) stream."""

    d: int = 12
    r: int = 3
    n_nodes: int = 4
    batch_size: int = 32
    # drifting stream: population C0 (lead) until stream step shift_at,
    # then an independently rotated C1 (shift_lead)
    gap: float = 0.6
    lead: float = 3.0
    shift_lead: float = 6.0
    shift_at: int = 8
    stream_seed: int = 0
    # held-out gate mass: fresh numpy draws from the same population at the
    # current stream step (never fed to the ingestor)
    holdout_seed: int = 777
    holdout_m: int = 512
    total_ticks: int = 26
    # re-solve: t_outer S-DOT iterations advanced resolve_chunk *
    # chunks_per_tick steps per service tick through run_chunked
    t_outer: int = 12
    t_c: int = 12
    resolve_chunk: int = 3
    chunks_per_tick: int = 1
    topology: dict = dataclasses.field(default_factory=lambda: {
        "kind": "er", "n": 4, "p": 0.6, "seed": 1})
    warmup_ticks: int = 2          # ticks before the initial cold solve
    drift_threshold: float = 0.25  # residual trigger (above sampling noise)
    drift_warmup: int = 3          # post-swap ticks with no trigger
    # query path
    queries_per_tick: int = 8
    queue_capacity: int = 32
    max_batch: int = 8
    deadline_s: float = 0.25
    query_mode: str = "project"
    staleness_bound: int = 20      # asserted ceiling on served staleness
    keep_last: int = 4
    seed: int = 0

    def to_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
        return path

    @classmethod
    def from_json(cls, path: str) -> "ServiceConfig":
        with open(path) as f:
            return cls(**json.load(f))


@dataclasses.dataclass
class ServiceDraws:
    """Draws to use in place of the port's own (each optional): the
    reference's, for parity. ``batch_fn(step, m)`` gives the stream's
    batches; ``served_q0`` (d, r) the first served Q; ``ritz_init`` (d, r+1)
    the Ritz track's start; ``cold_qinit(resolve_id)`` (d, r) each cold
    re-solve's Q_init."""

    batch_fn: Optional[Callable] = None
    served_q0: Optional[np.ndarray] = None
    ritz_init: Optional[np.ndarray] = None
    cold_qinit: Optional[Callable[[int], np.ndarray]] = None


@dataclasses.dataclass(frozen=True)
class Served:
    """The served subspace: the host copy (gate, snapshot, digest) and the
    same bits on the device (what queries and the drift read use). The
    service replaces the whole pair in one assignment."""

    host: np.ndarray
    device: torch.Tensor

    @classmethod
    def of(cls, q, device: torch.device) -> "Served":
        host = np.array(q.cpu() if isinstance(q, torch.Tensor) else q,
                        np.float32)
        return cls(host, torch.from_numpy(host).to(device))


def _touch(path: str) -> None:
    with open(path, "w") as f:
        f.write(str(time.time()))


def _own_init(seed: int, d: int, r: int) -> np.ndarray:
    """The port's own orthonormal draw: a CPU generator, the same bits on
    every device."""
    return orthonormal_init(torch.Generator().manual_seed(seed), d,
                            r).numpy()


class PSAService:
    """The tick loop (see module docstring). One instance is one process
    attempt; construction resumes from the newest restorable snapshot in
    ``workdir`` or starts fresh. ``device`` defaults to CUDA."""

    def __init__(self, cfg: ServiceConfig, workdir: str,
                 plan: Optional[FaultPlan] = None, *,
                 device: DeviceLike = None,
                 draws: Optional[ServiceDraws] = None):
        self.cfg = cfg
        self.workdir = workdir
        self.device = dev = resolve_device(device)
        self.draws = draws or ServiceDraws()
        os.makedirs(workdir, exist_ok=True)
        # the process journal and a fresh metrics registry: the runtime,
        # checkpoint and chaos seams pick the journal up via get_journal(),
        # the query path shares the registry
        self.journal = obs_install(workdir, "service")
        self.registry = obs_metrics()
        state_root = os.path.join(workdir, _STATE)
        self.resolve_root = os.path.join(workdir, _RESOLVE)
        chaos_dir = os.path.join(workdir, "chaos_state")
        # two hook instances over one plan: faults target the service tick
        # boundary (worker "service") or the re-solve chunk boundary
        # (worker "resolve"), both at absolute step numbers
        self.hooks = ChaosHooks(plan, worker="service",
                                n_boundaries=cfg.total_ticks,
                                ckpt_root=state_root, state_dir=chaos_dir,
                                step_boundaries=True)
        self.resolve_hooks = ChaosHooks(plan, worker="resolve",
                                        n_boundaries=cfg.t_outer,
                                        ckpt_root=self.resolve_root,
                                        state_dir=chaos_dir,
                                        step_boundaries=True)
        self.state_mgr = CheckpointManager(
            state_root, keep_last=cfg.keep_last, on_save=self._on_tick_save)

        batch_fn, (c0, _), (c1, self.q_post) = drifting_eigengap_stream(
            cfg.d, cfg.r, cfg.gap, cfg.shift_at, seed=cfg.stream_seed,
            lead=cfg.lead, shift_lead=cfg.shift_lead, device=dev)
        self._hold_chol = tuple(
            np.linalg.cholesky(c.cpu().numpy().astype(np.float64)
                               + 1e-12 * np.eye(cfg.d)) for c in (c0, c1))
        self.ingestor = StreamingIngestor(
            n_nodes=cfg.n_nodes, d=cfg.d,
            batch_fn=self.draws.batch_fn or batch_fn,
            batch_size=cfg.batch_size, track_top=cfg.r, ritz_seed=cfg.seed,
            ritz_init=self.draws.ritz_init, device=dev)
        self.engine = build_engine(cfg.topology, device=dev)
        self.detector = DriftDetector(residual_threshold=cfg.drift_threshold,
                                      warmup=cfg.drift_warmup)
        self.queries = QueryPath(capacity=cfg.queue_capacity,
                                 max_batch=cfg.max_batch,
                                 deadline_s=cfg.deadline_s,
                                 mode=cfg.query_mode, hooks=self.hooks,
                                 registry=self.registry, device=dev)
        self.queries.warmup(cfg.d, cfg.r)
        self.history: list = []      # per-tick metrics (host-only)

        # -- mutable service state (the checkpointed tree) ------------------
        self.tick = -1                           # last COMPLETED tick
        q0 = self.draws.served_q0
        self.served = Served.of(_own_init(cfg.seed, cfg.d, cfg.r)
                                if q0 is None else q0, dev)
        self.served_at = -1                      # tick of last swap
        self.served_stream_step = 0              # freeze step of served Q
        self.swaps = 0
        self.gate_rejects = 0
        self.cold_resolves = 0                   # gate-fallback cold starts
        self.max_staleness = 0
        self.baseline_gap = 0.0
        self.resolve_active = False
        self.resolve_cold = True
        self.resolve_id = -1                     # id of the ACTIVE resolve
        self.resolve_done = 0                    # absolute steps completed
        self.resolve_frozen_step = 0
        self.resolve_covs = torch.zeros((cfg.n_nodes, cfg.d, cfg.d),
                                        dtype=torch.float32, device=dev)
        self.resolve_qinit = np.zeros((cfg.d, cfg.r), np.float32)
        self._claim_stream(state_root)
        self._restore()

    @property
    def served_q(self) -> np.ndarray:
        """The served subspace's host copy."""
        return self.served.host

    # -- checkpointing ------------------------------------------------------
    def _claim_stream(self, state_root: str) -> None:
        """Record whose stream the snapshots in ``state_root`` index, or
        refuse a directory whose snapshots index another stream."""
        want = {"stream": ("injected" if self.draws.batch_fn is not None
                           else "torch.Generator"),
                "device": self.device.type}
        path = os.path.join(state_root, _STREAM)
        if os.path.exists(path):
            with open(path) as f:
                have = json.load(f)
            if have != want:
                raise ValueError(
                    f"{state_root} holds snapshots of the stream {have}, not "
                    f"this service's {want}: its stream positions index other "
                    "draws; resume it where it was written or start in a "
                    "fresh workdir")
        elif self.state_mgr.all_steps():
            raise ValueError(
                f"{state_root} holds service snapshots with no {_STREAM}: "
                "written by the JAX reference service, whose jax.random "
                "stream positions the port cannot continue; resume it with "
                "the reference or start in a fresh workdir")
        else:
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(want, f)
            os.replace(tmp, path)

    def _tree(self) -> dict:
        return {
            "tick": np.int32(self.tick),
            "served_q": self.served.host,
            "served_at": np.int32(self.served_at),
            "served_stream_step": np.int32(self.served_stream_step),
            "swaps": np.int32(self.swaps),
            "gate_rejects": np.int32(self.gate_rejects),
            "cold_resolves": np.int32(self.cold_resolves),
            "max_staleness": np.int32(self.max_staleness),
            "baseline_gap": np.float32(self.baseline_gap),
            "resolve": {
                "active": np.int32(self.resolve_active),
                "cold": np.int32(self.resolve_cold),
                "id": np.int32(self.resolve_id),
                "done": np.int32(self.resolve_done),
                "frozen_step": np.int32(self.resolve_frozen_step),
                "covs": self.resolve_covs,
                "qinit": self.resolve_qinit,
            },
            "ingest": self.ingestor.state(),
        }

    def _adopt(self, tree: dict) -> None:
        self.tick = int(tree["tick"])
        self.served = Served.of(tree["served_q"], self.device)
        self.served_at = int(tree["served_at"])
        self.served_stream_step = int(tree["served_stream_step"])
        self.swaps = int(tree["swaps"])
        self.gate_rejects = int(tree["gate_rejects"])
        self.cold_resolves = int(tree["cold_resolves"])
        self.max_staleness = int(tree["max_staleness"])
        self.baseline_gap = float(tree["baseline_gap"])
        res = tree["resolve"]
        self.resolve_active = bool(int(res["active"]))
        self.resolve_cold = bool(int(res["cold"]))
        self.resolve_id = int(res["id"])
        self.resolve_done = int(res["done"])
        self.resolve_frozen_step = int(res["frozen_step"])
        self.resolve_covs = res["covs"]
        self.resolve_qinit = np.asarray(res["qinit"], np.float32)
        self.ingestor.restore(tree["ingest"])

    def _restore(self) -> None:
        """Adopt the newest restorable snapshot (corrupt steps skipped) and
        record whether the restored served subspace matches the pinned
        last-good one bit for bit."""
        template = self._tree()
        steps = self.state_mgr.all_steps()
        for step in reversed(steps):
            try:
                tree, _ = self.state_mgr.restore(template, step=step)
            except _RESTORE_ERRORS:
                continue
            self._adopt(tree)
            pinned = self.state_mgr.pinned_steps()
            match = None
            if pinned:
                try:
                    ptree, _ = self.state_mgr.restore(template,
                                                      step=pinned[-1])
                    match = bool(np.array_equal(
                        np.asarray(ptree["served_q"], np.float32),
                        self.served.host))
                except _RESTORE_ERRORS:
                    match = False
            self._event({"type": "restore", "tick": self.tick,
                         "from_step": step, "pinned_match": match})
            return

    def _on_tick_save(self, step: int) -> None:
        # beat BEFORE chaos: a hang must leave a stale heartbeat for the
        # supervisor's watchdog to see
        _touch(os.path.join(self.workdir, _HEARTBEAT))
        self.hooks.at_boundary(step)

    def _on_resolve_save(self, step: int) -> None:
        _touch(os.path.join(self.workdir, _HEARTBEAT))
        self.resolve_hooks.at_boundary(step)

    def _event(self, doc: dict) -> None:
        # append-only across restarts; a re-executed tick appends an
        # identical duplicate, which service_summary drops
        with open(os.path.join(self.workdir, _EVENTS), "a") as f:
            f.write(json.dumps(doc) + "\n")

    # -- held-out quality gate ----------------------------------------------
    def _holdout_cov(self) -> np.ndarray:
        """Fresh (d, d) sample covariance from the CURRENT population: numpy
        draws the ingestor never saw, keyed by the stream step (the
        reference's, bit for bit)."""
        cfg = self.cfg
        step = self.ingestor.step
        chol = self._hold_chol[0 if step < cfg.shift_at else 1]
        rng = np.random.default_rng(cfg.holdout_seed * 9973 + step)
        x = chol @ rng.standard_normal((cfg.d, cfg.holdout_m))
        return (x @ x.T / cfg.holdout_m).astype(np.float32)

    def _gate(self, candidate: np.ndarray) -> tuple:
        """(accept, reason, cand_ev, inc_ev): the candidate must be finite,
        orthonormal, and explain >= the incumbent's variance on held-out
        mass (a 1e-3 relative slack)."""
        if not np.all(np.isfinite(candidate)):
            return False, "nonfinite", float("nan"), float("nan")
        gram = candidate.T @ candidate
        ortho = float(np.linalg.norm(gram - np.eye(self.cfg.r)))
        if ortho > 1e-2:
            return False, f"nonorthonormal({ortho:.2e})", float("nan"), \
                float("nan")
        c_hold = self._holdout_cov()
        inc = self.served.host
        cand_ev = float(np.trace(candidate.T @ c_hold @ candidate))
        inc_ev = float(np.trace(inc.T @ c_hold @ inc))
        if cand_ev < inc_ev * (1.0 - 1e-3):
            return False, "worse_than_incumbent", cand_ev, inc_ev
        return True, "ok", cand_ev, inc_ev

    # -- re-solve lifecycle -------------------------------------------------
    def _start_resolve(self, *, cold: bool) -> None:
        cfg = self.cfg
        self.resolve_id += 1
        self.resolve_active = True
        self.resolve_cold = cold
        self.resolve_done = 0
        self.resolve_frozen_step = self.ingestor.step
        self.resolve_covs = self.ingestor.cov_stack()
        if not cold:
            self.resolve_qinit = self.served.host.copy()
        elif self.draws.cold_qinit is not None:
            self.resolve_qinit = np.asarray(
                self.draws.cold_qinit(self.resolve_id), np.float32)
        else:
            self.resolve_qinit = _own_init(
                cfg.seed * 7 + 100 + self.resolve_id, cfg.d, cfg.r)
        shutil.rmtree(self.resolve_root, ignore_errors=True)
        self._event({"type": "start", "tick": self.tick + 1,
                     "resolve_id": self.resolve_id, "cold": cold,
                     "frozen_step": self.resolve_frozen_step})
        self.journal.event("resolve_start", "resolve",
                           tick=self.tick + 1, resolve_id=self.resolve_id,
                           cold=cold, frozen_step=self.resolve_frozen_step)

    def _advance_resolve(self) -> None:
        """A few chunks of the active re-solve, to an ABSOLUTE target step:
        a crashed tick's re-execution restores the re-solve RunState at (or
        past) the same target and never advances it twice."""
        cfg = self.cfg
        target = min(self.resolve_done + cfg.resolve_chunk
                     * cfg.chunks_per_tick, cfg.t_outer)
        mgr = CheckpointManager(self.resolve_root, keep_last=3,
                                on_save=self._on_resolve_save)
        program = sdot_program(
            covs=self.resolve_covs, engine=self.engine, r=cfg.r,
            t_outer=cfg.t_outer, t_c=cfg.t_c,
            q_init=torch.from_numpy(self.resolve_qinit).to(self.device),
            device=self.device)
        with self.journal.span("resolve_increment", "resolve",
                               tick=self.tick + 1,
                               resolve_id=self.resolve_id,
                               target=target, cold=self.resolve_cold):
            result = run_chunked(program, mgr, chunk_size=cfg.resolve_chunk,
                                 target_step=target)
        self.resolve_done = target
        if target < cfg.t_outer:
            return
        # complete: average the node iterates, re-orthonormalize, hand the
        # candidate to chaos (the gate's adversary), then gate it
        candidate = cholesky_qr2(result.q_nodes.mean(dim=0))[0].cpu().numpy()
        candidate = np.asarray(self.hooks.mangle_candidate(
            candidate, self.resolve_id), np.float32)
        gate_sp = self.journal.begin("gate", "resolve",
                                     tick=self.tick + 1,
                                     resolve_id=self.resolve_id)
        accept, reason, cand_ev, inc_ev = self._gate(candidate)
        gate_sp.end(accept=accept, reason=reason)
        if accept:
            # the atomic swap: one assignment publishes both copies
            self.served = Served.of(candidate, self.device)
            self.served_at = self.tick + 1
            self.served_stream_step = self.resolve_frozen_step
            self.swaps += 1
            self.baseline_gap = self.ingestor.eigengap
            self.resolve_active = False
            self._event({"type": "swap", "tick": self.tick + 1,
                         "resolve_id": self.resolve_id,
                         "cold": self.resolve_cold,
                         "cand_ev": round(cand_ev, 6),
                         "inc_ev": round(inc_ev, 6),
                         "frozen_step": self.resolve_frozen_step})
            self.journal.event("swap", "resolve", tick=self.tick + 1,
                               resolve_id=self.resolve_id,
                               frozen_step=self.resolve_frozen_step)
            self.registry.counter("serving_swaps_total").inc()
        else:
            # never served: incumbent stays, cold re-solve from fresh seed
            self.gate_rejects += 1
            self.cold_resolves += 1
            self._event({"type": "reject", "tick": self.tick + 1,
                         "resolve_id": self.resolve_id, "reason": reason,
                         "cand_ev": cand_ev, "inc_ev": inc_ev})
            self.journal.event("reject", "resolve", tick=self.tick + 1,
                               resolve_id=self.resolve_id, reason=reason)
            self.registry.counter("serving_gate_rejects_total").inc()
            self._start_resolve(cold=True)

    # -- the tick -----------------------------------------------------------
    def _run_tick(self) -> None:
        cfg = self.cfg
        tick = self.tick + 1
        jl = self.journal
        # one span per tick; a kill mid-tick leaves it (and the phase span
        # it died inside) without its closing record
        tick_sp = jl.begin("tick", "serving", tick=tick)

        # 1) ingest this tick's micro-batch (pure in (seed, step))
        with jl.span("ingest", "serving", tick=tick):
            self.ingestor.ingest(1)

        # 2) re-solve lifecycle: advance the active one, or decide to start
        if self.resolve_active:
            self._advance_resolve()
        elif self.swaps == 0:
            if tick >= cfg.warmup_ticks:
                self._start_resolve(cold=True)
                self._advance_resolve()
        else:
            with jl.span("drift_read", "serving", tick=tick) as dsp:
                stats = self.detector.read(
                    self.ingestor, self.served.device,
                    baseline_gap=self.baseline_gap,
                    ticks_since_swap=tick - self.served_at)
                dsp.add(triggered=bool(stats.triggered))
            if stats.triggered:
                self._start_resolve(cold=False)   # warm: from the served Q
                self._advance_resolve()

        # 3) queries against whatever is served right now
        with jl.span("query_drain", "serving", tick=tick) as qsp:
            rng = np.random.default_rng(cfg.seed * 31 + 17 + tick)
            for j in range(cfg.queries_per_tick):
                req_id = tick * cfg.queries_per_tick + j
                self.queries.submit(req_id, rng.standard_normal(cfg.d))
            answered = len(self.queries.process(self.served.device))
            expired = self.queries.drain_expired()
            qsp.add(answered=answered, drain_expired=expired)

        # 4) staleness: served-from freeze step vs ingested step
        staleness = (self.ingestor.step - self.served_stream_step
                     if self.swaps else 0)
        self.max_staleness = max(self.max_staleness, staleness)
        self.registry.gauge("serving_staleness_ticks").set(staleness)
        self.history.append({
            "tick": tick, "staleness": staleness, "swaps": self.swaps,
            "resolve_active": self.resolve_active,
            "resolve_done": self.resolve_done if self.resolve_active else 0})

        # 5) commit the tick (blocking: pins must follow a published step);
        #    a kill at this boundary re-executes the whole tick, a pure
        #    function of the previous snapshot
        self.tick = tick
        with jl.span("tick_checkpoint", "serving", tick=tick):
            self.state_mgr.save(tick, self._tree(), blocking=True)
        if self.served_at == tick:
            # pin the snapshot holding the just-swapped subspace; retire
            # older pins so exactly the last-good generation survives GC
            self.state_mgr.pin(tick)
            for s in self.state_mgr.pinned_steps():
                if s != tick:
                    self.state_mgr.unpin(s)
        tick_sp.end(staleness=staleness, swaps=self.swaps)

    def run(self, until: Optional[int] = None) -> "PSAService":
        stop = self.cfg.total_ticks if until is None else until
        while self.tick + 1 < stop:
            self._run_tick()
        return self

    # -- reporting ----------------------------------------------------------
    def snapshot_bytes(self) -> int:
        """Bytes of one tick's snapshot (every leaf of the tree)."""
        return int(sum(leaf.nbytes if isinstance(leaf, np.ndarray)
                       else leaf.numel() * leaf.element_size()
                       if isinstance(leaf, torch.Tensor)
                       else np.asarray(leaf).nbytes
                       for leaf in _tree.tree_leaves(self._tree())))

    def summary(self) -> dict:
        return {
            "tick": self.tick,
            "swaps": self.swaps,
            "gate_rejects": self.gate_rejects,
            "cold_resolves": self.cold_resolves,
            "served_at": self.served_at,
            "served_stream_step": self.served_stream_step,
            "max_staleness": self.max_staleness,
            "served_sha256": hashlib.sha256(
                self.served.host.tobytes()).hexdigest(),
            "queries": self.queries.summary(),
        }

    def finalize(self) -> dict:
        """Publish the completion marker the supervisor looks for, and the
        registry's dump beside the journal."""
        _touch(os.path.join(self.workdir, _HEARTBEAT))   # alive till marked
        doc = self.summary()
        with open(os.path.join(self.workdir, _FINAL), "w") as f:
            json.dump(doc, f, indent=2)
        obs_dir = obs_dir_for(self.workdir)
        if obs_dir is not None:
            self.registry.dump(os.path.join(obs_dir, "metrics.service.json"))
        return doc


# ---------------------------------------------------------------------------
# event-log digest (trajectory comparison across runs)
# ---------------------------------------------------------------------------
def service_summary(workdir: str) -> dict:
    """final.json + the deduplicated event trajectory.

    Events are append-only across restarts, so a re-executed tick appends
    identical duplicates; the first per (type, tick, resolve_id) is kept.
    The swap/reject tick lists are the trajectory two runs compare on."""
    with open(os.path.join(workdir, _FINAL)) as f:
        doc = json.load(f)
    events, seen = [], set()
    path = os.path.join(workdir, _EVENTS)
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                ev = json.loads(line)
                key = (ev["type"], ev["tick"], ev.get("resolve_id"))
                if key in seen:
                    continue
                seen.add(key)
                events.append(ev)
    doc["swap_ticks"] = [e["tick"] for e in events if e["type"] == "swap"]
    doc["reject_ticks"] = [e["tick"] for e in events if e["type"] == "reject"]
    doc["restores"] = [e for e in events if e["type"] == "restore"]
    return doc


# ---------------------------------------------------------------------------
# supervision: subprocess + heartbeat watchdog + relaunch with backoff
# ---------------------------------------------------------------------------
def _child_env(env: Optional[dict]) -> dict:
    """The child's environment, with this package's source root first on
    ``PYTHONPATH`` so ``-m repro_torch.serving.service`` resolves."""
    out = dict(env) if env is not None else os.environ.copy()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in out.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return out


def run_supervised(cfg: ServiceConfig, workdir: str, *,
                   device: DeviceLike = None,
                   stall_timeout: float = 8.0, startup_timeout: float = 240.0,
                   poll: float = 0.3, max_relaunches: int = 6,
                   backoff: float = 0.25, env: Optional[dict] = None,
                   verbose: bool = False) -> dict:
    """Run the service to completion in a supervised subprocess.

    The child heartbeats at every tick and re-solve-chunk save and before
    its completion marker; the supervisor kills it when the beat goes
    stale (a wedged process stops beating but never exits) and relaunches
    with linear backoff. A beat older than this attempt's spawn counts as
    "not yet started", judged against ``startup_timeout`` (the first tick
    pays the CUDA context and the load of the kernel libraries). A child
    whose completion marker is newer than its spawn has done its work and
    only exits (its summary, the interpreter's and CUDA's teardown, which
    beat nothing and on a loaded host can outlast a short
    ``stall_timeout``): it is given ``startup_timeout`` for that. ``device`` is
    passed to the child as ``--device``; without it the child runs on
    CUDA, and raises where there is no card."""
    os.makedirs(workdir, exist_ok=True)
    spec = os.path.join(workdir, "service.json")
    cfg.to_json(spec)
    beat_path = os.path.join(workdir, _HEARTBEAT)
    final_path = os.path.join(workdir, _FINAL)
    cmd = [sys.executable, "-m", "repro_torch.serving.service", "--run", spec,
           "--workdir", workdir]
    if device is not None:
        cmd += ["--device", str(device)]
    child_env = _child_env(env)
    attempts, relaunches = 0, 0
    while True:
        attempts += 1
        spawn_t = time.time()
        proc = subprocess.Popen(cmd, env=child_env)
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            now = time.time()
            beat = os.path.getmtime(beat_path) \
                if os.path.exists(beat_path) else 0.0
            done = os.path.getmtime(final_path) \
                if os.path.exists(final_path) else 0.0
            if done >= spawn_t:         # finished: only its exit is left
                stale = now - done > startup_timeout
            elif beat > spawn_t:
                stale = now - beat > stall_timeout
            else:
                stale = now - spawn_t > startup_timeout
            if stale:
                proc.kill()
                proc.wait()
                rc = "stalled"
                break
            time.sleep(poll)
        if verbose:
            print(f"[supervisor] attempt {attempts}: rc={rc}", flush=True)
        if rc == 0 and os.path.exists(final_path):
            break
        if relaunches >= max_relaunches:
            raise RuntimeError(
                f"service did not complete within {max_relaunches} "
                f"relaunches (last rc={rc})")
        relaunches += 1
        time.sleep(backoff * relaunches)
    doc = service_summary(workdir)
    doc["attempts"] = attempts
    doc["relaunches"] = relaunches
    return doc


# ---------------------------------------------------------------------------
# seeded serving-chaos smoke scenario
# ---------------------------------------------------------------------------
def smoke_plan(resolve_boundary: int = 6) -> FaultPlan:
    """``run_smoke``'s kill / kill / hang plan: kill at the save of service
    tick 7 (the tick is re-executed after the relaunch), kill at the
    re-solve's chunk boundary ``resolve_boundary`` (it resumes from its
    RunState), and a wedge at tick 12 that the watchdog must catch. The
    reference's plan has boundary 6, a chunk boundary at its default
    ``resolve_chunk`` of 3; a config with another chunk size passes one of
    its own boundaries."""
    return FaultPlan(seed=0, faults=[
        {"kind": "kill", "worker": "service", "boundary": 7},
        {"kind": "kill", "worker": "resolve", "boundary": resolve_boundary},
        {"kind": "hang", "worker": "service", "boundary": 12, "sleep": 60},
    ])


def gate_plan() -> FaultPlan:
    """``run_smoke``'s gate plan: NaN in the first drift-triggered warm
    re-solve's candidate, and ~40% of queries delayed past their
    deadline."""
    return FaultPlan(seed=0, faults=[
        {"kind": "corrupt_candidate", "mode": "nan", "resolve": 1},
        {"kind": "delay_query", "p": 0.4, "delay": 0.5},
    ])


def run_smoke(workdir: str, *, device: DeviceLike = None,
              verbose: bool = True) -> dict:
    """The serving-chaos scenario, its checks asserted:

    (a) a fault-free in-process run;
    (b) the same config supervised under ``smoke_plan``: the served
        trajectory (swap ticks and served bits) equal to (a)'s, every
        restore matching the pinned last-good snapshot, exactly three
        relaunches;
    (c) ``gate_plan`` in-process: the gate rejects the mangled candidate,
        a cold re-solve recovers close to the post-shift truth, and
        delayed queries expire instead of blocking.
    """
    cfg = ServiceConfig()
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)

    # (a) fault-free reference
    ref_dir = os.path.join(workdir, "ref")
    t0 = time.perf_counter()
    PSAService(cfg, ref_dir, device=dev).run().finalize()
    ref_s = time.perf_counter() - t0
    ref = service_summary(ref_dir)
    assert ref["swaps"] >= 2, ref          # initial solve + >=1 drift swap
    assert ref["gate_rejects"] == 0, ref
    assert ref["max_staleness"] <= cfg.staleness_bound, ref
    assert ref["queries"]["answered"] > 0, ref

    # (b) kill/kill/hang under supervision: the same trajectory
    chaos_dir = os.path.join(workdir, "chaos")
    os.makedirs(chaos_dir, exist_ok=True)
    plan_path = smoke_plan().dump(os.path.join(chaos_dir, "plan.json"))
    env = os.environ.copy()
    env[ENV_PLAN] = plan_path
    t0 = time.perf_counter()
    chaos = run_supervised(cfg, chaos_dir, device=dev, env=env,
                           verbose=verbose)
    chaos_s = time.perf_counter() - t0
    assert chaos["relaunches"] == 3, chaos
    assert chaos["served_sha256"] == ref["served_sha256"], (chaos, ref)
    assert chaos["swap_ticks"] == ref["swap_ticks"], (chaos, ref)
    assert chaos["swaps"] == ref["swaps"], (chaos, ref)
    assert chaos["gate_rejects"] == 0, chaos
    assert chaos["max_staleness"] <= cfg.staleness_bound, chaos
    # every restore that had a pin matched it bitwise; at least one did
    matches = [e["pinned_match"] for e in chaos["restores"]]
    assert all(m is not False for m in matches), chaos["restores"]
    assert any(m is True for m in matches), chaos["restores"]

    # (c) corrupt candidate + delayed queries, in-process
    gate_dir = os.path.join(workdir, "gate")
    svc = PSAService(cfg, gate_dir, plan=gate_plan(), device=dev).run()
    gate = svc.finalize()
    assert gate["gate_rejects"] == 1, gate       # the mangled candidate
    assert gate["cold_resolves"] == 1, gate      # ... fell back cold
    assert gate["swaps"] >= 2, gate              # ... and recovered
    assert np.all(np.isfinite(svc.served_q))     # NaN never served
    post_err = float(subspace_error(svc.q_post, svc.served.device))
    assert post_err < 0.2, post_err              # recovered to the truth
    assert gate["queries"]["expired"] > 0, gate  # delays expired, not slept
    assert gate["max_staleness"] <= cfg.staleness_bound, gate

    summary = {
        "ref": {**{k: ref[k] for k in ("swaps", "swap_ticks",
                                       "served_sha256", "max_staleness")},
                "wall_s": ref_s},
        "chaos": {"relaunches": chaos["relaunches"],
                  "restores": len(chaos["restores"]),
                  "pinned_match": matches,
                  "swap_ticks": chaos["swap_ticks"],
                  "trajectory_bitwise_equal": True,
                  "wall_s": chaos_s},
        "gate": {"gate_rejects": gate["gate_rejects"],
                 "cold_resolves": gate["cold_resolves"],
                 "swaps": gate["swaps"],
                 "post_shift_subspace_err": post_err,
                 "queries": gate["queries"]},
    }
    if verbose:
        print(json.dumps(summary, indent=2), flush=True)
    return summary


def main(argv=None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", metavar="SPEC",
                    help="run a service to total_ticks from a JSON config")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="run the seeded serving-chaos scenario")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which raises where "
                         "there is no card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    if args.smoke:
        workdir = args.workdir or tempfile.mkdtemp(prefix="serving_smoke_")
        run_smoke(workdir, device=args.device)
        return 0
    if not args.run:
        ap.error("nothing to do (pass --run SPEC or --smoke)")
    cfg = ServiceConfig.from_json(args.run)
    workdir = args.workdir or os.path.dirname(os.path.abspath(args.run))
    plan_path = os.environ.get(ENV_PLAN)
    plan = FaultPlan.load(plan_path) if plan_path else None
    PSAService(cfg, workdir, plan=plan, device=args.device).run().finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
