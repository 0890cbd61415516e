"""S-DOT and SA-DOT: sample-wise distributed orthogonal iteration (Alg. 1).

The twin of ``repro/core/sdot.py`` for the synchronous engines. The two
algorithms share one implementation and differ only in the consensus budget
``schedule`` (constant for S-DOT, increasing for SA-DOT).

All N node states are carried as one stacked (N, d, r) tensor on the
engine's device. Step 5 on raw data, V_i = X_i (X_i^T Q_i) / n_i, is one
launch of the Hopper gram-apply kernel per outer iteration
(``kernels/ops.batched_gram_apply``); no node forms a d x d covariance.

Execution modes (``fused`` flag):
  * fused (default): ``runtime.run_monolithic`` over ``sdot_program``. No
    host sync inside the loop: debiasing divides by a row of the device
    table of W^t e_1, each iteration's error is kept on the device as its
    (N, r, r) cross products Q_true^T Q_i, whose singular values the
    runtime takes after the loop, and the ledger is priced in closed form.
    The schedule is host data, so each outer iteration runs exactly
    ``schedule[t]`` rounds. ``streaming/resume.sdot_chunked`` runs the same
    Program chunk by chunk with checkpoints.
  * eager (``fused=False``): the reference's loop, with the host debias
    weights and one host sync per iteration (the error value).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..kernels import ops as kops
from . import runtime
from .consensus import (DenseConsensus, check_sync_engine,
                        consensus_schedule, debiased_gossip)
from .linalg import cholesky_qr2, orthonormal_init
from .metrics import CommLedger, subspace_error_from_cross

__all__ = ["SDOTResult", "sdot", "sadot", "sdot_program", "local_cov_apply"]


@dataclasses.dataclass
class SDOTResult:
    q_nodes: torch.Tensor               # (N, d, r) final per-node estimates
    error_trace: Optional[np.ndarray]   # (T_o,) mean subspace error vs q_true
    consensus_trace: np.ndarray         # (T_o,) consensus rounds per outer iter
    ledger: CommLedger                  # communication accounting

    @property
    def q_mean(self) -> torch.Tensor:
        """Consensus-averaged estimate (for reporting; nodes already agree)."""
        return self.q_nodes.mean(dim=0)


def local_cov_apply(covs: torch.Tensor, q_nodes: torch.Tensor) -> torch.Tensor:
    """Step 5 of Alg. 1 at every node: Z_i = M_i Q_i. covs: (N, d, d)."""
    return covs @ q_nodes


def _stack_data(xs: Sequence[torch.Tensor], device: torch.device):
    """Zero-pad ragged node blocks (d, n_i) to one (N, d, n_max) stack.

    Padding is exact for the gram apply; the true n_i go along for the
    normalizer. n_max is rounded up to a multiple of 4, so that the rows of
    the stack are 16-byte aligned and the gram-apply kernel can read it
    through TMA.
    """
    n_true = np.array([x.shape[1] for x in xs], np.float32)
    n_max = -(-int(n_true.max()) // 4) * 4
    stack = torch.stack([F.pad(x.to(device, torch.float32),
                               (0, n_max - x.shape[1])) for x in xs])
    return stack, torch.as_tensor(n_true, device=device)


def _apply_operand(operand, mode: str, q_nodes: torch.Tensor) -> torch.Tensor:
    """Step 5 of Alg. 1 for either operand layout (cov stack or raw data)."""
    if mode == "cov":
        return local_cov_apply(operand, q_nodes)
    x_stack, n_true = operand
    return kops.batched_gram_apply(x_stack, q_nodes, n_true)


def _prepare_sdot(*, covs, data, engine, r, t_outer, schedule, t_c, q_init,
                  q_true, generator, device):
    """Validate and normalise a run's inputs into device-ready pieces."""
    check_sync_engine(engine)
    if (covs is None) == (data is None):
        raise ValueError("provide exactly one of covs / data")
    dev = resolve_device(device)
    if engine.device != dev:
        raise ValueError(f"engine lives on {engine.device}, run asked for "
                         f"{dev}")
    n = engine.graph.n_nodes
    if covs is not None:
        d = covs.shape[1]
        if covs.shape[0] != n:
            raise ValueError("covs leading dim must equal number of nodes")
        operand, mode = covs.to(dev, torch.float32), "cov"
    else:
        d = data[0].shape[0]
        if len(data) != n:
            raise ValueError("need one data block per node")
        operand, mode = _stack_data(data, dev), "data"

    if schedule is None:
        schedule = consensus_schedule("const", t_outer, t_max=t_c)
    elif len(schedule) < t_outer:
        raise ValueError(f"schedule has {len(schedule)} entries but "
                         f"t_outer={t_outer}")
    sched = np.asarray(schedule[:t_outer])
    if q_init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        q_init = orthonormal_init(generator, d, r, device=dev)
    # all nodes start from the same Q_init (Theorem 1 requires it)
    q_nodes = q_init.to(dev, torch.float32)[None].expand(n, d, r).contiguous()
    if q_true is not None:
        q_true = q_true.to(dev, torch.float32)
    return operand, mode, q_nodes, sched, q_true, d


def _sync_outer_body(operand, w, table: torch.Tensor,
                     q_true: Optional[torch.Tensor], *, mode: str,
                     t_max: int):
    """One outer iteration ``(q_nodes, t_c) -> (q_new, cross)``, the body
    every runtime driver steps through (``cross`` is None without a ground
    truth)."""

    def outer(q_nodes, t_c):
        z0 = _apply_operand(operand, mode, q_nodes)              # (N, d, r)
        v = debiased_gossip(w, table, z0, t_c, t_max)
        q_new = cholesky_qr2(v)[0]                               # per node
        return q_new, None if q_true is None else q_true.mT @ q_new

    return outer


def _sdot_build_body(operands, *, mode: str, t_max: int):
    """The Program protocol's ``build_body`` for S-DOT/SA-DOT."""
    return _sync_outer_body(*operands, mode=mode, t_max=t_max)


def sdot_program(
    *,
    covs: Optional[torch.Tensor] = None,
    data: Optional[Sequence[torch.Tensor]] = None,
    engine: DenseConsensus,
    r: int,
    t_outer: int,
    schedule: Optional[np.ndarray] = None,
    t_c: int = 50,
    q_init: Optional[torch.Tensor] = None,
    q_true: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> runtime.Program:
    """Register an S-DOT/SA-DOT run with the runtime: ``run_monolithic``
    gives ``sdot(fused=True)``, ``run_chunked`` its restartable twin. Built
    from the same ``_prepare_sdot`` as the eager oracle."""
    operand, mode, q_nodes, sched, q_true, d = _prepare_sdot(
        covs=covs, data=data, engine=engine, r=r, t_outer=t_outer,
        schedule=schedule, t_c=t_c, q_init=q_init, q_true=q_true,
        generator=generator, device=device)
    t_max = int(sched.max()) if t_outer else 0

    def finalize(state: runtime.RunState, done: int) -> SDOTResult:
        ledger = CommLedger()
        ledger.log_gossip_rounds(sched[:done], engine.graph.adjacency, d * r,
                                 engine.payload_bytes_per_elem)
        return SDOTResult(
            q_nodes=state.q,
            error_trace=(None if q_true is None
                         else state.errs[:done].cpu().numpy().copy()),
            consensus_trace=sched[:done], ledger=ledger)

    return runtime.Program(
        build_body=_sdot_build_body,
        operands=(operand, engine._w, engine.debias_table(t_max), q_true),
        statics=(("mode", mode), ("t_max", t_max)),
        xs=sched, q0=q_nodes, finalize=finalize)


def sdot(
    *,
    covs: Optional[torch.Tensor] = None,
    data: Optional[Sequence[torch.Tensor]] = None,
    engine: DenseConsensus,
    r: int,
    t_outer: int,
    schedule: Optional[np.ndarray] = None,
    t_c: int = 50,
    q_init: Optional[torch.Tensor] = None,
    q_true: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    fused: bool = True,
    device: DeviceLike = None,
) -> SDOTResult:
    """Run S-DOT / SA-DOT over a simulated network.

    Exactly one of ``covs`` (N, d, d) or ``data`` (list of (d, n_i)) must be
    given. ``schedule`` overrides ``t_c`` (constant) and makes this SA-DOT.
    ``generator`` draws Q_init where ``q_init`` is not given. ``device``
    defaults to CUDA and must be the engine's device.
    """
    kw = dict(covs=covs, data=data, engine=engine, r=r, t_outer=t_outer,
              schedule=schedule, t_c=t_c, q_init=q_init, q_true=q_true,
              generator=generator, device=device)
    if fused:
        return runtime.run_monolithic(sdot_program(**kw))
    operand, mode, q_nodes, sched, q_true, d = _prepare_sdot(**kw)
    ledger = CommLedger()
    errs = []
    for t in range(t_outer):
        z0 = _apply_operand(operand, mode, q_nodes)               # (N, d, r)
        v = engine.run_debiased(z0, int(sched[t]), ledger)
        q_nodes = cholesky_qr2(v)[0]                              # per node
        if q_true is not None:
            errs.append(float(subspace_error_from_cross(
                q_true.mT @ q_nodes).mean()))
    return SDOTResult(
        q_nodes=q_nodes,
        error_trace=None if q_true is None else np.asarray(errs, np.float64),
        consensus_trace=sched, ledger=ledger)


def sadot(*, schedule_kind: str = "lin2", cap: Optional[int] = None,
          t_outer: int, **kw) -> SDOTResult:
    """SA-DOT convenience wrapper: increasing consensus schedule."""
    sched = consensus_schedule(schedule_kind, t_outer, cap=cap)
    return sdot(t_outer=t_outer, schedule=sched, **kw)
