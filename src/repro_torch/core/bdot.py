"""B-DOT: block-partitioned distributed orthogonal iteration.

The twin of ``repro/core/bdot.py``. Nodes form an I x J grid; node (i, j)
holds the block X_ij (d_i x n_j) (feature slab i of sample shard j) and
estimates the rows Q_i of the global basis. One outer iteration computes
V = X X^T Q block-wise:

    S_j = sum_i X_ij^T Q_i      consensus along grid COLUMN j (payload n_j x r)
    W_i = sum_j X_ij S_j        consensus along grid ROW i    (payload d_i x r)
    Q_i = distributed CholeskyQR over the row representatives (r x r Grams)

Execution modes (``fused`` flag, as in ``sdot.py`` / ``fdot.py``):
  * fused (default): ``runtime.run_monolithic`` over ``bdot_program``. The
    ragged grid is zero-padded into one (I, J, d_max, n_max) stack (n_max a
    multiple of 4 on the card, for the grid apply kernel's TMA route) and
    the row iterates into (I, d_max, r). The padding is exact: padded feature
    rows are zero in X_ij and Q_i; padded sample columns of X_ij give zero
    rows of Z_ij, which stay zero through gossip (a convex row mix) and
    debiasing, so stage 2 never reads anything but zeros there. Stages 1
    and 2 are one launch each of the Hopper grid kernels
    (``kernels/ops.grid_block_tq`` / ``grid_block_apply``); the J column
    (I row) gossips run as one batched matmul per round over the stacked
    (J, I, I) ((I, J, J)) weights, or, over sparse engines, one batched ELL
    launch per round over their ``SparseW.stack``, each sub-network
    debiased by its own device table.
    Stage 3 is the in-loop distributed CholeskyQR over the column-0 engine,
    its I Grams one launch of the Gram kernel a pass. No host sync inside
    the loop; the ledger is priced in closed form.
    ``streaming/resume.bdot_chunked`` runs the same Program chunk by chunk.
  * eager (``fused=False``): the reference's per-iteration loop over the
    ragged block lists, one gossip call per column and per row. It also
    takes asynchronous and faulty engines, each call drawing from the
    engine's own stream through its ``run_debiased``, as the reference's
    eager loop does; the fused path needs ``debias_table`` on every
    engine.
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
from .consensus import DenseConsensus, consensus_schedule, debiased_gossip
from .fdot import (QR_PASSES, _qr_pass, distributed_cholesky_qr,
                   split_pad_rows)
from .linalg import orthonormal_init
from .metrics import CommLedger, subspace_error
from .sparse import SparseW

__all__ = ["BDOTResult", "bdot", "bdot_program", "pad_grid_blocks"]


def _stack_weights(engines: Sequence[DenseConsensus]):
    """Stack per-sub-network mixing weights for the batched gossip stages:
    all-dense engines to a (B, N, N) tensor, all-sparse engines to one
    stacked ``SparseW`` (one ELL launch a round for all B). A stage that
    mixes the two has no batched form and is refused."""
    ws = [e._w for e in engines]
    n_sparse = sum(isinstance(w, SparseW) for w in ws)
    if n_sparse == 0:
        return torch.stack(ws)
    if n_sparse != len(ws):
        raise ValueError(
            "B-DOT stage mixes sparse and dense engines; pass sparse=True "
            "or sparse=False uniformly per stage")
    return SparseW.stack(ws)


@dataclasses.dataclass
class BDOTResult:
    q_rows: List[torch.Tensor]      # per feature-slab Q_i (d_i x r), consensus
    error_trace: Optional[np.ndarray]
    ledger: CommLedger

    @property
    def q_full(self) -> torch.Tensor:
        return torch.cat(self.q_rows, dim=0)


def pad_grid_blocks(blocks: Sequence[Sequence[torch.Tensor]],
                    col_multiple: int = 1) -> torch.Tensor:
    """Zero-pad an I x J grid of ragged (d_i, n_j) blocks to one
    (I, J, d_max, n_max) stack, n_max rounded up to ``col_multiple`` (the
    module docstring says why the padding is exact through all three B-DOT
    stages)."""
    d_max = max(int(row[0].shape[0]) for row in blocks)
    n_max = max(int(b.shape[1]) for b in blocks[0])
    n_max = -(-n_max // col_multiple) * col_multiple
    return torch.stack([
        torch.stack([F.pad(b, (0, n_max - b.shape[1], 0, d_max - b.shape[0]))
                     for b in row])
        for row in blocks])


@dataclasses.dataclass
class _BDOTRun:
    """A run's inputs, validated and on the device."""
    blocks: List[List[torch.Tensor]]
    dims: List[int]
    n_samps: List[int]
    t_c_qr: int
    schedule: np.ndarray
    q_init: torch.Tensor
    q_true: Optional[torch.Tensor]
    t_max: int


def _prepare_bdot(*, blocks, col_engines, row_engines, r, t_outer, t_c,
                  t_c_qr, schedule, q_init, q_true, generator,
                  device) -> _BDOTRun:
    """Validate and normalise a B-DOT run's inputs (shared by both modes)."""
    dev = resolve_device(device)
    n_rows, n_cols = len(blocks), len(blocks[0])
    if len(col_engines) != n_cols or len(row_engines) != n_rows:
        raise ValueError("need one column engine per grid column and one "
                         "row engine per grid row")
    for eng in list(col_engines) + list(row_engines):
        if eng.device != dev:
            raise ValueError(f"engine lives on {eng.device}, run asked for "
                             f"{dev}")
    dims = [int(blocks[i][0].shape[0]) for i in range(n_rows)]
    n_samps = [int(blocks[0][j].shape[1]) for j in range(n_cols)]
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
        q_init = orthonormal_init(generator, sum(dims), r, device=dev)
    return _BDOTRun(
        blocks=[[b.to(dev, torch.float32) for b in row] for row in blocks],
        dims=dims, n_samps=n_samps, t_c_qr=t_c_qr, schedule=schedule,
        q_init=q_init.to(dev, torch.float32),
        q_true=None if q_true is None else q_true.to(dev, torch.float32),
        t_max=int(max(schedule.max(), t_c_qr)) if t_outer else t_c_qr)


def _bdot_ledger(run: _BDOTRun, col_engines, row_engines, r: int,
                 done: int) -> CommLedger:
    """Closed-form accounting of the first ``done`` outer iterations (the
    reference's ``bdot_program`` finalize)."""
    sched = run.schedule[:done]
    ledger = CommLedger()
    for j, eng in enumerate(col_engines):
        ledger.log_gossip_rounds(sched, eng.graph.adjacency,
                                 run.n_samps[j] * r,
                                 eng.payload_bytes_per_elem)
    for i, eng in enumerate(row_engines):
        ledger.log_gossip_rounds(sched, eng.graph.adjacency, run.dims[i] * r,
                                 eng.payload_bytes_per_elem)
    ledger.log_gossip_rounds(np.full(done, QR_PASSES * run.t_c_qr),
                             col_engines[0].graph.adjacency, r * r,
                             col_engines[0].payload_bytes_per_elem)
    return ledger


def _bdot_outer_body(x_grid, w_col, tab_col, w_row, tab_row,
                     qtrue_pad: Optional[torch.Tensor], *, t_max: int,
                     t_c_qr: int):
    """One outer iteration ``(q_pad, t_c) -> (q_new, cross)``: two
    grid-kernel launches, the batched column and row gossips, and two
    distributed CholeskyQR passes (``cross`` is None without a ground
    truth)."""

    def outer(q_pad, t_c):
        # stage 1: column-wise consensus over the (n_max, r) partials
        z = kops.grid_block_tq(x_grid, q_pad).transpose(0, 1)  # (J, I, n, r)
        s = debiased_gossip(w_col, tab_col, z, t_c, t_max).mean(dim=1)
        # stage 2: row-wise consensus over the (d_max, r) expansions
        v = kops.grid_block_apply(x_grid, s)               # (I, J, d_max, r)
        q_pad = debiased_gossip(w_row, tab_row, v, t_c, t_max).mean(dim=1)
        # stage 3: distributed CholeskyQR across the I feature slabs
        for _ in range(QR_PASSES):
            q_pad = _qr_pass(w_col[0], tab_col[0], q_pad, t_c_qr, t_c_qr)
        cross = (None if qtrue_pad is None
                 else torch.einsum("idr,ids->rs", qtrue_pad, q_pad))
        return q_pad, cross

    return outer


def _bdot_build_body(operands, *, t_max: int, t_c_qr: int):
    """The Program protocol's ``build_body`` for B-DOT (sync engines)."""
    return runtime.sync_body(
        _bdot_outer_body(*operands, t_max=t_max, t_c_qr=t_c_qr))


def bdot_program(
    *,
    blocks: Sequence[Sequence[torch.Tensor]],
    col_engines: Sequence[DenseConsensus],
    row_engines: Sequence[DenseConsensus],
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
    """Register a B-DOT run with the runtime: ``run_monolithic`` gives
    ``bdot(fused=True)``, ``run_chunked`` its restartable twin. Every row
    and column engine must mix on the device (``debias_table``)."""
    if not all(hasattr(e, "debias_table")
               for e in list(col_engines) + list(row_engines)):
        raise ValueError("fused B-DOT needs fused-capable engines "
                         "(debias_table) on every row and column")
    run = _prepare_bdot(blocks=blocks, col_engines=col_engines,
                        row_engines=row_engines, r=r, t_outer=t_outer,
                        t_c=t_c, t_c_qr=t_c_qr, schedule=schedule,
                        q_init=q_init, q_true=q_true, generator=generator,
                        device=device)
    t_max = run.t_max
    qtrue_pad = (None if run.q_true is None
                 else split_pad_rows(run.q_true, run.dims))
    operands = (
        # on the card, sample columns padded to a multiple of 4: the grid
        # apply kernel's TMA route reads 16-byte rows
        pad_grid_blocks(run.blocks, 4 if run.q_init.is_cuda else 1),
        _stack_weights(col_engines),                       # (J, I, I)
        torch.stack([e.debias_table(t_max) for e in col_engines]),
        _stack_weights(row_engines),                       # (I, J, J)
        torch.stack([e.debias_table(t_max) for e in row_engines]),
        qtrue_pad)

    def finalize(state: runtime.RunState, done: int) -> BDOTResult:
        return BDOTResult(
            q_rows=[state.q[i, :di] for i, di in enumerate(run.dims)],
            error_trace=(None if run.q_true is None
                         else state.errs[:done].cpu().numpy().copy()),
            ledger=_bdot_ledger(run, col_engines, row_engines, r, done))

    return runtime.Program(
        build_body=_bdot_build_body, operands=operands,
        statics=(("t_max", t_max), ("t_c_qr", run.t_c_qr)),
        xs=run.schedule, q0=split_pad_rows(run.q_init, run.dims),
        finalize=finalize)


def bdot(
    *,
    blocks: Sequence[Sequence[torch.Tensor]],   # blocks[i][j]: (d_i, n_j)
    col_engines: Sequence[DenseConsensus],
    row_engines: Sequence[DenseConsensus],
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
) -> BDOTResult:
    """Run B-DOT over a simulated I x J node grid.

    ``col_engines[j]`` gossips over the I nodes of column j (n_j x r
    partials); ``row_engines[i]`` over the J nodes of row i (d_i x r
    partials). The final QR gossips r x r Grams over ``col_engines[0]``.
    ``schedule`` overrides ``t_c`` for stages 1-2 (the QR stage keeps the
    constant ``t_c_qr``, default ``t_c``). ``device`` defaults to CUDA and
    must be every engine's device.
    """
    kw = dict(blocks=blocks, col_engines=col_engines,
              row_engines=row_engines, r=r, t_outer=t_outer, t_c=t_c,
              t_c_qr=t_c_qr, schedule=schedule, q_init=q_init,
              q_true=q_true, generator=generator, device=device)
    if fused:
        return runtime.run_monolithic(bdot_program(**kw))
    run = _prepare_bdot(**kw)

    n_rows, n_cols = len(run.blocks), len(run.blocks[0])
    offs = np.cumsum([0] + run.dims)
    q_rows = [run.q_init[offs[i]:offs[i + 1]] for i in range(n_rows)]
    ledger = CommLedger()
    errs = []
    for t_c_t in run.schedule:
        t_c_t = int(t_c_t)
        # stage 1: per column j, consensus-sum the (n_j x r) partials
        s_cols = []
        for j in range(n_cols):
            z0 = torch.stack([run.blocks[i][j].mT @ q_rows[i]
                              for i in range(n_rows)])        # (I, n_j, r)
            s_cols.append(col_engines[j].run_debiased(z0, t_c_t,
                                                      ledger).mean(0))
        # stage 2: per row i, consensus-sum the (d_i x r) expansions
        new_rows = []
        for i in range(n_rows):
            z0 = torch.stack([run.blocks[i][j] @ s_cols[j]
                              for j in range(n_cols)])        # (J, d_i, r)
            new_rows.append(row_engines[i].run_debiased(z0, t_c_t,
                                                        ledger).mean(0))
        # stage 3: distributed CholeskyQR across feature slabs
        q_rows = distributed_cholesky_qr(new_rows, col_engines[0],
                                         run.t_c_qr, ledger)
        if run.q_true is not None:
            errs.append(float(subspace_error(run.q_true,
                                             torch.cat(q_rows))))
    return BDOTResult(
        q_rows=q_rows,
        error_trace=np.asarray(errs) if run.q_true is not None else None,
        ledger=ledger)
