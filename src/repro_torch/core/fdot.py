"""F-DOT: feature-wise distributed orthogonal iteration (Alg. 2).

The twin of ``repro/core/fdot.py`` for the synchronous engines. Node i holds
a feature slab X_i (d_i x n). One outer iteration:
  1. Z_i = X_i^T Q_i                              (local, n x r)
  2. consensus-average + debias -> S ~= sum_j X_j^T Q_j at every node
  3. V_i = X_i S_i                                (local, d_i x r)
  4. distributed QR of the stacked V by CholeskyQR2:
       G_i = V_i^T V_i ; G = consensus-sum G_i (r x r traffic only);
       R = chol(G)^T ; Q_i = V_i R^{-1}     (x2 passes)

Execution modes (``fused`` flag, as in ``sdot.py``):
  * fused (default): ``runtime.run_monolithic`` over ``fdot_program``. The
    ragged slabs are zero-padded to one (N, d_max, n) stack (exact: padded
    rows are null in every product) and steps 1 and 3 are one launch each
    of the Hopper slab kernels (``kernels/ops.batched_slab_tq`` /
    ``batched_slab_apply``). No host sync inside the loop: debiasing divides
    by a row of the device table, each CholeskyQR pass takes its N Grams in
    one launch of the Gram kernel (``kernels/ops.gram_qr``), then
    ``cholesky_ex`` and one batched triangular solve; each iteration's cross
    product Q_true^T Q stays on the device until the runtime takes its SVD
    after the loop, and the ledger is priced in closed form.
    ``streaming/resume.fdot_chunked`` runs the same Program chunk by chunk.
  * eager (``fused=False``): the reference's per-iteration loop over the
    ragged slab lists, with host debias weights and one host sync per
    iteration (the error value). Its distributed QR forms each node's Gram
    with its own product, so the fused-vs-eager checks hold the kernel
    against an independent computation.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..kernels import ops as kops
from . import runtime
from .consensus import (DenseConsensus, check_sync_engine,
                        consensus_schedule, debiased_gossip)
from .linalg import orthonormal_init
from .metrics import CommLedger, subspace_error

__all__ = ["FDOTResult", "fdot", "fdot_program", "distributed_cholesky_qr",
           "pad_feature_slabs", "unpad_feature_slabs", "split_pad_rows"]

QR_PASSES = 2


@dataclasses.dataclass
class FDOTResult:
    q_blocks: List[torch.Tensor]    # per-node slabs Q_{f,i} (d_i x r)
    error_trace: Optional[np.ndarray]
    ledger: CommLedger

    @property
    def q_full(self) -> torch.Tensor:
        return torch.cat(self.q_blocks, dim=0)


def pad_feature_slabs(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Zero-pad ragged (d_i, m) node slabs to one (N, d_max, m) stack.

    Exact for every product in Alg. 2: a padded row is null on both sides of
    X^T Q, contributes a zero row to X S, and adds nothing to V^T V.
    """
    d_max = max(int(b.shape[0]) for b in blocks)
    return torch.stack([F.pad(b, (0, 0, 0, d_max - b.shape[0]))
                        for b in blocks])


def unpad_feature_slabs(stack: torch.Tensor,
                        dims: Sequence[int]) -> List[torch.Tensor]:
    """Inverse of pad_feature_slabs given the true per-node row counts."""
    return [stack[i, :di] for i, di in enumerate(dims)]


def split_pad_rows(full: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """Split a stacked (d, r) matrix into per-node row slabs and zero-pad to
    one (N, d_max, r) stack (the layout of the fused iterates)."""
    offs = np.cumsum([0] + list(dims))
    return pad_feature_slabs(
        [full[offs[i]:offs[i + 1]] for i in range(len(dims))])


def _cholesky_upper(gsum: torch.Tensor) -> torch.Tensor:
    """Upper R with R^T R = sym(gsum) + 1e-10 I, no host sync (cholesky_ex
    does not check the result, as ``jnp.linalg.cholesky`` does not)."""
    r = gsum.shape[-1]
    g = (0.5 * (gsum + gsum.mT)
         + 1e-10 * torch.eye(r, dtype=gsum.dtype, device=gsum.device))
    return torch.linalg.cholesky_ex(g).L.mT


def distributed_cholesky_qr(v_blocks: Sequence[torch.Tensor],
                            engine: DenseConsensus, t_c: int,
                            ledger: Optional[CommLedger] = None,
                            passes: int = QR_PASSES) -> List[torch.Tensor]:
    """Distributed QR of row-partitioned V = [V_1; ...; V_N] by CholeskyQR.

    Only r x r Gram matrices cross the network. With passes=2 this is
    CholeskyQR2 and the result is orthonormal to ~machine precision. The
    eager oracle: one gossip call and one Cholesky per node per pass.
    """
    check_sync_engine(engine)
    blocks = [v.float() for v in v_blocks]
    for _ in range(passes):
        grams = torch.stack([b.mT @ b for b in blocks])          # (N, r, r)
        gsum = engine.run_debiased(grams, t_c, ledger)           # approx sum
        blocks = [torch.linalg.solve_triangular(
            _cholesky_upper(gsum[i]), b, upper=True, left=False)
            for i, b in enumerate(blocks)]
    return blocks


def _solve_from_gram_sum(gsum: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Finish one in-loop CholeskyQR pass from consensus-summed Grams:
    symmetrise + jitter, Cholesky, and one batched triangular solve over the
    padded (N, d_max, r) slabs."""
    return torch.linalg.solve_triangular(_cholesky_upper(gsum), v,
                                         upper=True, left=False)


def _qr_pass(w, table: torch.Tensor, v: torch.Tensor, t_qr: int,
             t_max: int) -> torch.Tensor:
    """One in-loop distributed CholeskyQR pass over padded slabs
    (N, d_max, r)."""
    grams = kops.gram_qr(v)                                       # (N, r, r)
    gsum = debiased_gossip(w, table, grams, t_qr, t_max)
    return _solve_from_gram_sum(gsum, v)


@dataclasses.dataclass
class _FDOTRun:
    """A run's inputs, validated and on the device."""
    dims: List[int]
    n_samples: int
    t_c_qr: int
    schedule: np.ndarray
    q_blocks: List[torch.Tensor]
    q_true: Optional[torch.Tensor]
    t_max: int
    device: torch.device


def _prepare_fdot(*, data_blocks, engine, r, t_outer, t_c, t_c_qr, schedule,
                  q_init, q_true, generator, device) -> _FDOTRun:
    """Validate and normalise an F-DOT run's inputs (shared by both modes,
    so the fused and eager runs start from the same values)."""
    check_sync_engine(engine)
    dev = resolve_device(device)
    if engine.device != dev:
        raise ValueError(f"engine lives on {engine.device}, run asked for "
                         f"{dev}")
    n_nodes = engine.graph.n_nodes
    if len(data_blocks) != n_nodes:
        raise ValueError("need one feature slab per node")
    dims = [int(x.shape[0]) for x in data_blocks]
    d = sum(dims)
    t_c_qr = int(t_c if t_c_qr is None else t_c_qr)

    if schedule is None:
        schedule = consensus_schedule("const", t_outer, t_max=t_c)
    elif len(schedule) < t_outer:
        raise ValueError(f"schedule has {len(schedule)} entries but "
                         f"t_outer={t_outer}")
    schedule = np.asarray(schedule[:t_outer])

    if q_init is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        q_init = orthonormal_init(generator, d, r, device=dev)
    q_init = q_init.to(dev, torch.float32)
    offs = np.cumsum([0] + dims)
    q_blocks = [q_init[offs[i]:offs[i + 1]] for i in range(n_nodes)]
    t_max = int(max(schedule.max(), t_c_qr)) if t_outer else 0
    return _FDOTRun(
        dims=dims, n_samples=int(data_blocks[0].shape[1]), t_c_qr=t_c_qr,
        schedule=schedule, q_blocks=q_blocks,
        q_true=None if q_true is None else q_true.to(dev, torch.float32),
        t_max=t_max, device=dev)


def _fdot_outer_body(x_pad, w, table: torch.Tensor,
                     qtrue_pad: Optional[torch.Tensor], *, t_max: int,
                     t_c_qr: int):
    """One outer iteration ``(q_pad, t_c) -> (q_new, cross)`` over the padded
    slabs: two slab-kernel launches and two distributed CholeskyQR passes
    (``cross`` is None without a ground truth)."""

    def outer(q_pad, t_c):
        z0 = kops.batched_slab_tq(x_pad, q_pad)                  # (N, n, r)
        s = debiased_gossip(w, table, z0, t_c, t_max)
        v = kops.batched_slab_apply(x_pad, s)                    # (N, d_max, r)
        for _ in range(QR_PASSES):
            v = _qr_pass(w, table, v, t_c_qr, t_max)
        cross = (None if qtrue_pad is None
                 else torch.einsum("idr,ids->rs", qtrue_pad, v))
        return v, cross

    return outer


def _fdot_build_body(operands, *, t_max: int, t_c_qr: int):
    """The Program protocol's ``build_body`` for F-DOT (sync engines)."""
    return _fdot_outer_body(*operands, t_max=t_max, t_c_qr=t_c_qr)


def fdot_program(
    *,
    data_blocks: Sequence[torch.Tensor],
    engine: DenseConsensus,
    r: int,
    t_outer: int,
    t_c: int = 50,
    t_c_qr: Optional[int] = None,
    schedule: Optional[np.ndarray] = None,
    q_init: Optional[torch.Tensor] = None,
    q_true: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> runtime.Program:
    """Register an F-DOT run with the runtime: ``run_monolithic`` gives
    ``fdot(fused=True)``, ``run_chunked`` its restartable twin."""
    run = _prepare_fdot(data_blocks=data_blocks, engine=engine, r=r,
                        t_outer=t_outer, t_c=t_c, t_c_qr=t_c_qr,
                        schedule=schedule, q_init=q_init, q_true=q_true,
                        generator=generator, device=device)
    x_pad = pad_feature_slabs([x.to(run.device, torch.float32)
                               for x in data_blocks])     # (N, d_max, n)
    qtrue_pad = (None if run.q_true is None
                 else split_pad_rows(run.q_true, run.dims))

    def finalize(state: runtime.RunState, done: int) -> FDOTResult:
        adj, bpe = engine.graph.adjacency, engine.payload_bytes_per_elem
        ledger = CommLedger()
        ledger.log_gossip_rounds(run.schedule[:done], adj, run.n_samples * r,
                                 bpe)
        ledger.log_gossip_rounds(np.full(done, QR_PASSES * run.t_c_qr), adj,
                                 r * r, bpe)
        return FDOTResult(
            q_blocks=unpad_feature_slabs(state.q, run.dims),
            error_trace=(None if run.q_true is None
                         else state.errs[:done].cpu().numpy().copy()),
            ledger=ledger)

    return runtime.Program(
        build_body=_fdot_build_body,
        operands=(x_pad, engine._w, engine.debias_table(run.t_max),
                  qtrue_pad),
        statics=(("t_max", run.t_max), ("t_c_qr", run.t_c_qr)),
        xs=run.schedule, q0=pad_feature_slabs(run.q_blocks),
        finalize=finalize)


def fdot(
    *,
    data_blocks: Sequence[torch.Tensor],   # node i: X_i (d_i x n)
    engine: DenseConsensus,
    r: int,
    t_outer: int,
    t_c: int = 50,
    t_c_qr: Optional[int] = None,
    schedule: Optional[np.ndarray] = None,
    q_init: Optional[torch.Tensor] = None,
    q_true: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    fused: bool = True,
    device: DeviceLike = None,
) -> FDOTResult:
    """Run F-DOT over a simulated network (Alg. 2).

    ``schedule`` overrides ``t_c`` with per-outer-iteration consensus budgets
    for the partial-product phase (the QR phase keeps the constant
    ``t_c_qr``, default ``t_c``). ``generator`` draws Q_init where
    ``q_init`` is not given. ``device`` defaults to CUDA and must be the
    engine's device.
    """
    kw = dict(data_blocks=data_blocks, engine=engine, r=r, t_outer=t_outer,
              t_c=t_c, t_c_qr=t_c_qr, schedule=schedule, q_init=q_init,
              q_true=q_true, generator=generator, device=device)
    if fused:
        return runtime.run_monolithic(fdot_program(**kw))
    run = _prepare_fdot(**kw)
    xs = [x.to(run.device, torch.float32) for x in data_blocks]

    ledger = CommLedger()
    errs = []
    q_blocks = run.q_blocks
    for t in range(t_outer):
        # steps 1-2: consensus over the (n x r) partial products
        z0 = torch.stack([x.mT @ q for x, q in zip(xs, q_blocks)])
        s = engine.run_debiased(z0, int(run.schedule[t]), ledger)
        # step 3: local expansion; step 4: distributed orthonormalisation
        v_blocks = [x @ s[i] for i, x in enumerate(xs)]
        q_blocks = distributed_cholesky_qr(v_blocks, engine, run.t_c_qr,
                                           ledger)
        if run.q_true is not None:
            errs.append(float(subspace_error(run.q_true,
                                             torch.cat(q_blocks))))
    return FDOTResult(
        q_blocks=q_blocks,
        error_trace=np.asarray(errs) if run.q_true is not None else None,
        ledger=ledger)
