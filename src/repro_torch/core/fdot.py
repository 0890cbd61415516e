"""F-DOT: feature-wise distributed orthogonal iteration (Alg. 2).

The twin of ``repro/core/fdot.py``. Node i holds
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
    Async and faulty engines gossip three times a step (the partial
    products, then each CholeskyQR pass), each call one draw of the run's
    key in that order; a faulty step holds one crash mask for all three
    and freezes crashed nodes' slabs at its end.
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
from .async_gossip import (GossipDraws, check_draws, engine_kind,
                           masked_async_rounds)
from .consensus import (DenseConsensus, consensus_schedule, debias_table,
                        debiased_gossip, lane_debiased_gossip)
from .linalg import orthonormal_init
from .metrics import CommLedger, subspace_error
from .netfaults import masked_faulty_rounds, realized_debias

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
                            passes: int = QR_PASSES,
                            awake_pad: Optional[int] = None,
                            faults_pad: Optional[int] = None,
                            node_up=None,
                            draws: Optional[GossipDraws] = None
                            ) -> List[torch.Tensor]:
    """Distributed QR of row-partitioned V = [V_1; ...; V_N] by CholeskyQR.

    Only r x r Gram matrices cross the network. With passes=2 this is
    CholeskyQR2 and the result is orthonormal to ~machine precision. The
    eager oracle: one gossip call and one Cholesky per node per pass.

    ``awake_pad``: with an async engine, each pass draws its awake masks
    padded to (awake_pad, N), as the fused executors draw, so a seeded
    eager run gives the fused run's rounds. ``faults_pad``/``node_up`` are
    the network-fault twin: each pass draws padded fault blocks and
    gossips under the iteration's crash mask. ``draws`` is where those
    draws come from (default: the engine's stream).
    """
    blocks = [v.float() for v in v_blocks]
    kind = engine_kind(engine)
    pad = {"faulty": faults_pad, "async": awake_pad}.get(kind)
    if pad is not None and draws is None:
        draws = GossipDraws.of(engine)
    for _ in range(passes):
        grams = torch.stack([b.mT @ b for b in blocks])          # (N, r, r)
        if pad is None:
            gsum = engine.run_debiased(grams, t_c, ledger)       # approx sum
        else:
            drawn, engine._key = draws.take(engine._key, pad)
            gsum = (engine.run_debiased(grams, t_c, ledger, faults=drawn,
                                        node_up=node_up) if kind == "faulty"
                    else engine.run_debiased(grams, t_c, ledger,
                                             awake=drawn))
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


def _cross(qtrue_pad: Optional[torch.Tensor], v: torch.Tensor):
    """Q_true^T Q over the padded slabs (None without a ground truth)."""
    return (None if qtrue_pad is None
            else torch.einsum("idr,ids->rs", qtrue_pad, v))


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
        return v, _cross(qtrue_pad, v)

    return outer


def _fdot_async_outer_body(x_pad, w, adj, draws: GossipDraws,
                           qtrue_pad: Optional[torch.Tensor], *, t_max: int,
                           t_c_qr: int):
    """Async twin of ``_fdot_outer_body`` in the unified signature: three
    draws of the key a step (partial products, QR pass 1, QR pass 2)."""

    def gossip(key, z, t_c):
        awake, key = draws.take(key, t_max)
        out, sends, counts = masked_async_rounds(w, adj, awake, t_c, z)
        return key, out, sends, counts

    def outer(carry_key, t_c):
        q_pad, key = carry_key
        z0 = kops.batched_slab_tq(x_pad, q_pad)                  # (N, n, r)
        key, s, sd, cnt = gossip(key, z0, t_c)
        v = kops.batched_slab_apply(x_pad, s)                    # (N, d_max, r)
        sends, counts = [sd], [cnt]
        for _ in range(QR_PASSES):
            key, gsum, sd, cnt = gossip(key, kops.gram_qr(v), t_c_qr)
            sends.append(sd)
            counts.append(cnt)
            v = _solve_from_gram_sum(gsum, v)
        return (v, key), (_cross(qtrue_pad, v), torch.stack(sends),
                          torch.stack(counts))

    return outer


def _fdot_faulty_outer_body(x_pad, w, adj, params, node_up_sched, table,
                            draws: GossipDraws,
                            qtrue_pad: Optional[torch.Tensor], *,
                            t_max: int, t_c_qr: int, debias: str):
    """Network-fault twin: the carry is ``(q_pad, ge, t)``. Three draws a
    step, the burst state threaded through the three gossip calls, one
    crash mask for all three, and crashed nodes' slabs frozen at the end of
    the step."""

    def gossip(key, ge, node_up, z, t_c):
        blocks, key = draws.take(key, t_max)
        out, p, ge, sends, counts = masked_faulty_rounds(
            w, adj, params, node_up, ge, blocks, t_c, z)
        out = (realized_debias(out, p) if debias == "realized"
               else out / table[t_c].to(out.dtype)[:, None, None])
        return key, ge, out, sends, counts

    def outer(carry_key, t_c):
        (q_pad, ge, t), key = carry_key
        node_up = node_up_sched[int(t)]                          # (N,)
        z0 = kops.batched_slab_tq(x_pad, q_pad)                  # (N, n, r)
        key, ge, s, sd, cnt = gossip(key, ge, node_up, z0, t_c)
        v = kops.batched_slab_apply(x_pad, s)                    # (N, d_max, r)
        sends, counts = [sd], [cnt]
        for _ in range(QR_PASSES):
            key, ge, gsum, sd, cnt = gossip(key, ge, node_up,
                                            kops.gram_qr(v), t_c_qr)
            sends.append(sd)
            counts.append(cnt)
            v = _solve_from_gram_sum(gsum, v)
        q_new = torch.where(node_up[:, None, None] > 0, v, q_pad)  # freeze
        carry = (q_new, ge, torch.tensor(int(t) + 1, dtype=torch.int32))
        return (carry, key), (_cross(qtrue_pad, q_new), torch.stack(sends),
                              torch.stack(counts))

    return outer


def _lane_slab(kernel, x_pad: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A lane slab kernel (``ops.lane_slab_tq`` / ``lane_slab_apply``) over
    (C, S, N, k, r) lanes: slabs shared by every lane (N, d_max, n), or one
    stack a case (C, N, d_max, n) over that case's S lanes."""
    c, s = y.shape[:2]
    if x_pad.dim() == 3:
        out = kernel(x_pad, y.reshape(c * s, *y.shape[2:]))
        return out.reshape(c, s, *out.shape[1:])
    return torch.stack([kernel(x_pad[i], y[i]) for i in range(c)])


def _fdot_lane_body(x_pad, ws, tables, qtrue_pad, *, t_c_qr: int):
    """``_fdot_outer_body`` over a sweep's (C, S, N, d_max, r) lanes: the
    slab kernels take the lanes through the ``ops`` lane dispatch, each
    gossip runs every lane under its case's budget and table row, and each
    CholeskyQR pass takes every lane's Grams in one launch. ``x_pad`` and
    ``qtrue_pad`` are shared, or stacked by case (ragged sweeps: all-zero
    padding slabs)."""
    qt = qtrue_pad if qtrue_pad is None or qtrue_pad.dim() == 3 \
        else qtrue_pad[:, None]

    def outer(q, t_cs):
        z0 = _lane_slab(kops.lane_slab_tq, x_pad, q)             # (.., n, r)
        s = lane_debiased_gossip(ws, tables, z0, t_cs)
        v = _lane_slab(kops.lane_slab_apply, x_pad, s)           # (.., d, r)
        budgets = [t_c_qr] * len(t_cs)
        for _ in range(QR_PASSES):
            gsum = lane_debiased_gossip(ws, tables, kops.gram_qr(v), budgets)
            v = _solve_from_gram_sum(gsum, v)
        cross = (None if qt is None
                 else torch.einsum("...idr,...ids->...rs", qt, v))
        return v, cross

    return outer


def _fdot_lane_build_body(operands, *, t_c_qr: int):
    """The Program protocol's ``build_body`` for a sweep's F-DOT lanes."""
    return runtime.sync_body(_fdot_lane_body(*operands, t_c_qr=t_c_qr))


def _fdot_build_body(operands, *, t_max: int, t_c_qr: int,
                     kind: str = "sync", debias: str = "realized"):
    """The Program protocol's ``build_body`` for F-DOT."""
    if kind == "faulty":
        return _fdot_faulty_outer_body(*operands, t_max=t_max,
                                       t_c_qr=t_c_qr, debias=debias)
    if kind == "async":
        return _fdot_async_outer_body(*operands, t_max=t_max, t_c_qr=t_c_qr)
    return runtime.sync_body(
        _fdot_outer_body(*operands, t_max=t_max, t_c_qr=t_c_qr))


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
    draws: Optional[Sequence] = None,
) -> runtime.Program:
    """Register an F-DOT run with the runtime: ``run_monolithic`` gives
    ``fdot(fused=True)``, ``run_chunked`` its restartable twin."""
    run = _prepare_fdot(data_blocks=data_blocks, engine=engine, r=r,
                        t_outer=t_outer, t_c=t_c, t_c_qr=t_c_qr,
                        schedule=schedule, q_init=q_init, q_true=q_true,
                        generator=generator, device=device)
    kind = engine_kind(engine)
    check_draws(draws, kind)
    debias = engine.debias if kind == "faulty" else "realized"
    x_pad = pad_feature_slabs([x.to(run.device, torch.float32)
                               for x in data_blocks])     # (N, d_max, n)
    qtrue_pad = (None if run.q_true is None
                 else split_pad_rows(run.q_true, run.dims))
    q0_pad = pad_feature_slabs(run.q_blocks)
    key0, tail, q0 = None, (), q0_pad
    if kind == "faulty":
        n = engine.graph.n_nodes
        node_up_sched = torch.as_tensor(
            engine.faults.validate(n, t_outer).node_up(t_outer, n),
            device=run.device)
        table = (debias_table(engine._w, run.t_max) if debias == "nominal"
                 else None)
        operands = (x_pad, engine._w, engine._adj, engine._params,
                    node_up_sched, table, GossipDraws.of(engine, draws),
                    qtrue_pad)
        key0, tail = engine._key, (1 + QR_PASSES, run.t_max)
        q0 = (q0_pad, engine._ge.clone(), torch.tensor(0, dtype=torch.int32))
    elif kind == "async":
        operands = (x_pad, engine._w, engine._adj,
                    GossipDraws.of(engine, draws), qtrue_pad)
        key0, tail = engine._key, (1 + QR_PASSES, run.t_max)
    else:
        operands = (x_pad, engine._w, engine.debias_table(run.t_max),
                    qtrue_pad)

    def finalize(state: runtime.RunState, done: int) -> FDOTResult:
        adj, bpe = engine.graph.adjacency, engine.payload_bytes_per_elem
        if kind == "sync":
            ledger = CommLedger()
            ledger.log_gossip_rounds(run.schedule[:done], adj,
                                     run.n_samples * r, bpe)
            ledger.log_gossip_rounds(np.full(done, QR_PASSES * run.t_c_qr),
                                     adj, r * r, bpe)
        else:
            if done == t_outer:
                engine._key = state.key.clone()
                if kind == "faulty":
                    engine._ge = state.q[1]
            ledger = runtime.async_ledger(
                run.schedule[:done], state.sends[:done], state.counts[:done],
                lambda s: (float(s[:, 0].sum()) * run.n_samples * r
                           + float(s[:, 1:].sum()) * r * r),
                lambda t_c_t: [((0,), t_c_t)] + [((1 + k,), run.t_c_qr)
                                                 for k in range(QR_PASSES)])
            if kind == "faulty":
                ledger.payload_bytes = ledger.scalars * bpe
        q_pad = state.q[0] if kind == "faulty" else state.q
        return FDOTResult(
            q_blocks=unpad_feature_slabs(q_pad, run.dims),
            error_trace=(None if run.q_true is None
                         else state.errs[:done].cpu().numpy().copy()),
            ledger=ledger)

    return runtime.Program(
        build_body=_fdot_build_body, operands=operands,
        statics=(("t_max", run.t_max), ("t_c_qr", run.t_c_qr),
                 ("kind", kind), ("debias", debias)),
        xs=run.schedule, q0=q0, key0=key0, tail=tail, finalize=finalize)


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
    draws: Optional[Sequence] = None,
) -> FDOTResult:
    """Run F-DOT over a simulated network (Alg. 2).

    ``schedule`` overrides ``t_c`` with per-outer-iteration consensus budgets
    for the partial-product phase (the QR phase keeps the constant
    ``t_c_qr``, default ``t_c``). ``generator`` draws Q_init where
    ``q_init`` is not given. ``device`` defaults to CUDA and must be the
    engine's device. ``draws`` (async and faulty engines): one injected
    block per gossip call, three a step in the reference's order (the
    partial products, QR pass 1, QR pass 2).
    """
    kw = dict(data_blocks=data_blocks, engine=engine, r=r, t_outer=t_outer,
              t_c=t_c, t_c_qr=t_c_qr, schedule=schedule, q_init=q_init,
              q_true=q_true, generator=generator, device=device)
    if fused:
        return runtime.run_monolithic(fdot_program(**kw, draws=draws))
    run = _prepare_fdot(**kw)
    kind = engine_kind(engine)
    check_draws(draws, kind)
    xs = [x.to(run.device, torch.float32) for x in data_blocks]
    source = GossipDraws.of(engine, draws) if kind != "sync" else None
    if kind == "faulty":
        n = engine.graph.n_nodes
        node_up_sched = engine.faults.validate(n, t_outer).node_up(t_outer, n)

    ledger = CommLedger()
    errs = []
    q_blocks = run.q_blocks
    for t in range(t_outer):
        t_c_t = int(run.schedule[t])
        node_up = node_up_sched[t] if kind == "faulty" else None
        # steps 1-2: consensus over the (n x r) partial products
        z0 = torch.stack([x.mT @ q for x, q in zip(xs, q_blocks)])
        if kind == "sync":
            s = engine.run_debiased(z0, t_c_t, ledger)
        else:
            drawn, engine._key = source.take(engine._key, run.t_max)
            s = (engine.run_debiased(z0, t_c_t, ledger, faults=drawn,
                                     node_up=node_up) if kind == "faulty"
                 else engine.run_debiased(z0, t_c_t, ledger, awake=drawn))
        # step 3: local expansion; step 4: distributed orthonormalisation
        v_blocks = [x @ s[i] for i, x in enumerate(xs)]
        pad = run.t_max if kind != "sync" else None
        new_blocks = distributed_cholesky_qr(
            v_blocks, engine, run.t_c_qr, ledger, awake_pad=pad,
            faults_pad=pad, node_up=node_up, draws=source)
        if kind == "faulty":
            # crashed nodes freeze their slab for the iteration
            new_blocks = [nb if node_up[i] > 0 else qb
                          for i, (nb, qb) in enumerate(zip(new_blocks,
                                                           q_blocks))]
        q_blocks = new_blocks
        if run.q_true is not None:
            errs.append(float(subspace_error(run.q_true,
                                             torch.cat(q_blocks))))
    return FDOTResult(
        q_blocks=q_blocks,
        error_trace=np.asarray(errs) if run.q_true is not None else None,
        ledger=ledger)
