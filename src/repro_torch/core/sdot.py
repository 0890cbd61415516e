"""S-DOT and SA-DOT: sample-wise distributed orthogonal iteration (Alg. 1).

The twin of ``repro/core/sdot.py``. The two
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
    With an ``AsyncConsensus`` engine each step draws its (t_max, N) awake
    block from the run's key and runs realized-matrix gossip with the exact
    realized debias; with a ``FaultyConsensus`` engine it draws its fault
    blocks, reads its crash mask from the step counter in the carry, and
    freezes crashed nodes' iterates. Their per-round sends and awake counts
    stay on the device in the ``RunState`` until ``finalize`` prices the
    realized ledger.
  * eager (``fused=False``): the reference's loop, with the host debias
    weights and one host sync per iteration (the error value). Async and
    faulty engines draw with the fused run's padded shape, so a seeded
    eager run gives the fused run's bits.

``draws`` (async and faulty engines): one injected awake or fault block
per outer step in place of the engine's stream (the parity tests pass the
reference's own draws).

``sdot_spmd`` is the node-a-process mode: each rank holds its own
covariance block and gossips over an ``SpmdConsensus``.
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
from .async_gossip import (GossipDraws, check_draws, draw_generator,
                           engine_kind, masked_async_rounds)
from .consensus import (DenseConsensus, consensus_schedule, debias_table,
                        debiased_gossip, lane_debiased_gossip)
from .linalg import cholesky_qr2, orthonormal_init
from .metrics import CommLedger, subspace_error_from_cross
from .netfaults import (masked_faulty_rounds, realized_debias,
                        sample_fault_blocks)

__all__ = ["SDOTResult", "sdot", "sadot", "sdot_program", "sdot_spmd",
           "local_cov_apply"]


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
    """Step 5 of Alg. 1 at every node: Z_i = M_i Q_i. covs: (N, d, d).

    A sweep's lanes, q_nodes (lanes..., N, d, r) with covs broadcast
    against them (shared (N, d, d), or one stack a case), take one product
    a lane: a broadcast matmul would copy the covs once a lane and might
    sum in another order, and one a lane keeps each lane's bits those of
    its single run, whatever else shares the sweep."""
    if q_nodes.dim() == 3:
        return covs @ q_nodes
    lanes = q_nodes.shape[:-3]
    cov = covs.expand(*lanes, *covs.shape[-3:])
    return torch.stack([cov[i] @ q_nodes[i] for i in np.ndindex(*lanes)]
                       ).reshape(q_nodes.shape)


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


def _cross(q_true: Optional[torch.Tensor], q_new: torch.Tensor):
    return None if q_true is None else q_true.mT @ q_new


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
        return q_new, _cross(q_true, q_new)

    return outer


def _async_outer_body(operand, w, adj, draws: GossipDraws, q_true, *,
                      mode: str, t_max: int):
    """Async twin of ``_sync_outer_body`` in the unified signature: each
    step takes its (t_max, N) awake block from the key and runs
    realized-matrix gossip."""

    def outer(carry_key, t_c):
        q_nodes, key = carry_key
        awake, key = draws.take(key, t_max)
        z0 = _apply_operand(operand, mode, q_nodes)              # (N, d, r)
        v, sends, counts = masked_async_rounds(w, adj, awake, t_c, z0)
        q_new = cholesky_qr2(v)[0]
        return (q_new, key), (_cross(q_true, q_new), sends, counts)

    return outer


def _faulty_outer_body(operand, w, adj, params, node_up_sched, table,
                       draws: GossipDraws, q_true, *, mode: str, t_max: int,
                       debias: str):
    """Network-fault twin: the carry is ``(q_nodes, ge, t)`` (the iterate,
    the Gilbert-Elliott state, the step counter that selects the crash
    mask of ``node_up_sched``). Crashed nodes' iterates are frozen, so on
    rejoin they re-sync through ordinary gossip. ``debias``: "realized"
    divides by the carried realized product, "nominal" by the fault-free
    table row."""

    def outer(carry_key, t_c):
        (q_nodes, ge, t), key = carry_key
        blocks, key = draws.take(key, t_max)
        node_up = node_up_sched[int(t)]                          # (N,)
        z0 = _apply_operand(operand, mode, q_nodes)              # (N, d, r)
        z, p, ge_new, sends, counts = masked_faulty_rounds(
            w, adj, params, node_up, ge, blocks, t_c, z0)
        v = (realized_debias(z, p) if debias == "realized"
             else z / table[t_c].to(z.dtype)[:, None, None])
        up = node_up[:, None, None] > 0
        q_new = torch.where(up, cholesky_qr2(v)[0], q_nodes)     # freeze
        carry = (q_new, ge_new, torch.tensor(int(t) + 1, dtype=torch.int32))
        return (carry, key), (_cross(q_true, q_new), sends, counts)

    return outer


def _lane_apply(operand, mode: str, q: torch.Tensor) -> torch.Tensor:
    """Step 5 of Alg. 1 for (C, S, N, d, r) lanes: a cov stack shared by
    every lane (N, d, d) or one a case (C, N, d, d), or raw data shared by
    every lane through ``ops.lane_gram_apply``."""
    if mode == "cov":
        return local_cov_apply(operand if operand.dim() == 3
                               else operand[:, None], q)
    x_stack, n_true = operand
    c, s = q.shape[:2]
    v = kops.lane_gram_apply(x_stack, q.reshape(c * s, *q.shape[2:]),
                             n_true)
    return v.reshape(q.shape)


def _lane_cross(q_true: Optional[torch.Tensor], q: torch.Tensor):
    """Q_true^T Q_i of every (C, S, N, d, r) lane, one product a lane as a
    single run takes it: a batched product's order may depend on its
    batch count, and a lane's trace must not depend on the grid around it
    (a shard of the seeds gives the grid's bits)."""
    if q_true is None:
        return None
    c, s = q.shape[:2]
    return torch.stack([q_true.mT @ q[i, j] for i in range(c)
                        for j in range(s)]).reshape(*q.shape[:-2],
                                                    q.shape[-1], q.shape[-1])


def _sync_lane_body(operand, ws, tables, q_true, *, mode: str):
    """``_sync_outer_body`` over a sweep's (C, S, N, d, r) lanes: step t
    takes each case's budget from the (C,) ``t_cs``, and every lane is
    debiased by its own case's table row. The QR's Grams of all lanes and
    nodes are one launch a pass."""

    def outer(q, t_cs):
        z0 = _lane_apply(operand, mode, q)
        v = lane_debiased_gossip(ws, tables, z0, t_cs)
        q_new = cholesky_qr2(v)[0]
        return q_new, _lane_cross(q_true, q_new)

    return outer


def _faulty_lane_body(covs, ws, adjs, params, node_up_sched, tables,
                      q_true, *, t_max: int, debias: str):
    """``_faulty_outer_body`` over a sweep's lanes: the carry is ``(q, ge,
    t)`` with q (C, S, N, d, r), ge (C, S, N, N) and t (C, S), the key
    (C, S, 2) ``[seed, counter]`` a lane. Each lane draws its own fault
    blocks and runs the family's own faulty rounds under its case's
    weights, knobs and crash mask; the cov apply and the QR run once for
    every lane."""

    def outer(carry_key, t_cs):
        (q, ge, t), key = carry_key
        c_n, s_n, n = q.shape[:3]
        step = int(t.reshape(-1)[0])
        z0 = _lane_apply(covs, "cov", q)
        vs, ges, sends, counts = [], [], [], []
        for c in range(c_n):
            node_up, t_c = node_up_sched[c, step], int(t_cs[c])
            for s in range(s_n):
                gen = draw_generator(int(key[c, s, 0]), int(key[c, s, 1]),
                                     q.device)
                blocks = sample_fault_blocks(gen, n, t_max, None)
                z, p, g, sd, ct = masked_faulty_rounds(
                    ws[c], adjs[c], params[c], node_up, ge[c, s], blocks,
                    t_c, z0[c, s])
                vs.append(realized_debias(z, p) if debias == "realized"
                          else z / tables[c, t_c].to(z.dtype)[:, None, None])
                ges.append(g)
                sends.append(sd)
                counts.append(ct)
        lanes = (c_n, s_n)
        v = torch.stack(vs).reshape(q.shape)
        up = node_up_sched[:, step][:, None, :, None, None] > 0
        q_new = torch.where(up, cholesky_qr2(v)[0], q)           # freeze
        key = key.clone()
        key[..., 1] += 1
        carry = (q_new, torch.stack(ges).reshape(ge.shape), t + 1)
        return (carry, key), (_lane_cross(q_true, q_new),
                              torch.stack(sends).reshape(*lanes, -1),
                              torch.stack(counts).reshape(*lanes, -1))

    return outer


def _sdot_lane_build_body(operands, *, mode: str, t_max: int,
                          kind: str = "sync", debias: str = "realized"):
    """The Program protocol's ``build_body`` for a sweep's S-DOT lanes."""
    if kind == "faulty":
        return _faulty_lane_body(*operands, t_max=t_max, debias=debias)
    return runtime.sync_body(_sync_lane_body(*operands, mode=mode))


def _sdot_build_body(operands, *, mode: str, t_max: int, kind: str = "sync",
                     debias: str = "realized"):
    """The Program protocol's ``build_body`` for S-DOT/SA-DOT."""
    if kind == "faulty":
        return _faulty_outer_body(*operands, mode=mode, t_max=t_max,
                                  debias=debias)
    if kind == "async":
        return _async_outer_body(*operands, mode=mode, t_max=t_max)
    return runtime.sync_body(
        _sync_outer_body(*operands, mode=mode, t_max=t_max))


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
    draws: Optional[Sequence] = None,
) -> runtime.Program:
    """Register an S-DOT/SA-DOT run with the runtime: ``run_monolithic``
    gives ``sdot(fused=True)``, ``run_chunked`` its restartable twin. Built
    from the same ``_prepare_sdot`` as the eager oracle."""
    operand, mode, q_nodes, sched, q_true, d = _prepare_sdot(
        covs=covs, data=data, engine=engine, r=r, t_outer=t_outer,
        schedule=schedule, t_c=t_c, q_init=q_init, q_true=q_true,
        generator=generator, device=device)
    t_max = int(sched.max()) if t_outer else 0
    kind = engine_kind(engine)
    check_draws(draws, kind)
    debias = engine.debias if kind == "faulty" else "realized"
    payload = d * r
    key0, tail, q0 = None, (), q_nodes
    if kind == "faulty":
        n = engine.graph.n_nodes
        node_up_sched = torch.as_tensor(
            engine.faults.validate(n, t_outer).node_up(t_outer, n),
            device=q_nodes.device)
        table = (debias_table(engine._w, t_max) if debias == "nominal"
                 else None)
        operands = (operand, engine._w, engine._adj, engine._params,
                    node_up_sched, table, GossipDraws.of(engine, draws),
                    q_true)
        key0, tail = engine._key, (t_max,)
        q0 = (q_nodes, engine._ge.clone(), torch.tensor(0, dtype=torch.int32))
    elif kind == "async":
        operands = (operand, engine._w, engine._adj,
                    GossipDraws.of(engine, draws), q_true)
        key0, tail = engine._key, (t_max,)
    else:
        operands = (operand, engine._w, engine.debias_table(t_max), q_true)

    def finalize(state: runtime.RunState, done: int) -> SDOTResult:
        if kind == "sync":
            ledger = CommLedger()
            ledger.log_gossip_rounds(sched[:done], engine.graph.adjacency,
                                     payload, engine.payload_bytes_per_elem)
        else:
            if done == t_outer:
                # the engine's stream (and burst state) where an eager run
                # leaves them
                engine._key = state.key.clone()
                if kind == "faulty":
                    engine._ge = state.q[1]
            ledger = runtime.async_ledger(
                sched[:done], state.sends[:done], state.counts[:done],
                lambda s: float(s.sum()) * payload,
                lambda t_c_t: [(slice(None), t_c_t)])
            if kind == "faulty":
                ledger.payload_bytes = (ledger.scalars
                                        * engine.payload_bytes_per_elem)
        return SDOTResult(
            q_nodes=state.q[0] if kind == "faulty" else state.q,
            error_trace=(None if q_true is None
                         else state.errs[:done].cpu().numpy().copy()),
            consensus_trace=sched[:done], ledger=ledger)

    return runtime.Program(
        build_body=_sdot_build_body, operands=operands,
        statics=(("mode", mode), ("t_max", t_max), ("kind", kind),
                 ("debias", debias)),
        xs=sched, q0=q0, key0=key0, tail=tail, finalize=finalize)


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
    draws: Optional[Sequence] = None,
) -> SDOTResult:
    """Run S-DOT / SA-DOT over a simulated network.

    Exactly one of ``covs`` (N, d, d) or ``data`` (list of (d, n_i)) must be
    given. ``schedule`` overrides ``t_c`` (constant) and makes this SA-DOT.
    ``generator`` draws Q_init where ``q_init`` is not given. ``device``
    defaults to CUDA and must be the engine's device. ``draws``: one
    injected awake or fault block per outer step (async and faulty
    engines).
    """
    kw = dict(covs=covs, data=data, engine=engine, r=r, t_outer=t_outer,
              schedule=schedule, t_c=t_c, q_init=q_init, q_true=q_true,
              generator=generator, device=device)
    if fused:
        return runtime.run_monolithic(sdot_program(**kw, draws=draws))
    operand, mode, q_nodes, sched, q_true, d = _prepare_sdot(**kw)
    kind = engine_kind(engine)
    check_draws(draws, kind)
    t_max = int(sched.max()) if t_outer else 0
    if kind != "sync":
        source = GossipDraws.of(engine, draws)
    if kind == "faulty":
        n = engine.graph.n_nodes
        node_up_sched = engine.faults.validate(n, t_outer).node_up(t_outer, n)
    ledger = CommLedger()
    errs = []
    for t in range(t_outer):
        t_c_t = int(sched[t])
        z0 = _apply_operand(operand, mode, q_nodes)               # (N, d, r)
        if kind == "sync":
            q_nodes = cholesky_qr2(engine.run_debiased(z0, t_c_t, ledger))[0]
        else:
            # the fused run's padded draw, so a seeded eager run gives its
            # bits
            blocks, engine._key = source.take(engine._key, t_max)
            if kind == "async":
                v = engine.run_debiased(z0, t_c_t, ledger, awake=blocks)
                q_nodes = cholesky_qr2(v)[0]
            else:
                node_up = node_up_sched[t]
                v = engine.run_debiased(z0, t_c_t, ledger, faults=blocks,
                                        node_up=node_up)
                up = torch.as_tensor(node_up > 0,
                                     device=q_nodes.device)[:, None, None]
                q_nodes = torch.where(up, cholesky_qr2(v)[0], q_nodes)
        if q_true is not None:
            errs.append(float(runtime.step_errors(
                [q_true.mT @ q_nodes])[0]))
    return SDOTResult(
        q_nodes=q_nodes,
        error_trace=None if q_true is None else np.asarray(errs, np.float64),
        consensus_trace=sched, ledger=ledger)


def sadot(*, schedule_kind: str = "lin2", cap: Optional[int] = None,
          t_outer: int, **kw) -> SDOTResult:
    """SA-DOT convenience wrapper: increasing consensus schedule."""
    sched = consensus_schedule(schedule_kind, t_outer, cap=cap)
    return sdot(t_outer=t_outer, schedule=sched, **kw)


def sdot_spmd(
    *,
    covs: torch.Tensor,
    engine,                                   # consensus.SpmdConsensus
    r: int,
    t_outer: int,
    schedule: Optional[np.ndarray] = None,
    t_c: int = 50,
    q_init: Optional[torch.Tensor] = None,
    q_true: Optional[torch.Tensor] = None,
    seed: int = 0,
) -> SDOTResult:
    """S-DOT / SA-DOT with one process a node: this rank's part of a run.

    ``covs`` is this rank's own (d, d) block M_i; ``engine`` an
    ``SpmdConsensus`` whose axis holds the N nodes. Every rank starts from
    the same ``q_init``: the one given, or one drawn from a CPU generator
    seeded by ``seed`` and moved to the engine's device (the same bits on
    every rank). Each outer iteration is the local apply, ``schedule[t]``
    gossip rounds, the debias by the device table's row and a CholeskyQR2
    (the Gram kernel on the card). The error trace (with ``q_true``) is
    the node mean of eq. (11), one all-reduce at the end; one all-gather
    fills ``q_nodes`` (N, d, r), so every rank returns the whole result,
    with the closed-form ledger.
    """
    dev = engine.device
    if covs.dim() != 2 or covs.shape[0] != covs.shape[1]:
        raise ValueError(f"covs must be this rank's (d, d) block, got "
                         f"{tuple(covs.shape)}")
    cov = covs.to(dev, torch.float32)
    d = cov.shape[0]
    if schedule is None:
        schedule = consensus_schedule("const", t_outer, t_max=t_c)
    elif len(schedule) < t_outer:
        raise ValueError(f"schedule has {len(schedule)} entries but "
                         f"t_outer={t_outer}")
    sched = np.asarray(schedule[:t_outer])
    t_max = int(sched.max()) if t_outer else 0
    if q_init is None:
        q_init = orthonormal_init(torch.Generator().manual_seed(seed), d, r,
                                  device=dev)
    q = q_init.to(dev, torch.float32)
    qt = None if q_true is None else q_true.to(dev, torch.float32)
    table = engine.debias_table(t_max)
    crosses = []
    for t_c_t in sched:
        z = cov @ q
        z = engine.gossip_rounds_masked(z, int(t_c_t), t_max)
        z = engine.debias_by_table(z, table, int(t_c_t))
        q = cholesky_qr2(z)[0]
        if qt is not None:
            crosses.append(qt.mT @ q)
    error_trace = None
    if qt is not None:
        errs = torch.zeros(len(crosses), device=dev)
        if crosses:
            errs = subspace_error_from_cross(torch.stack(crosses))
        errs = engine.group.all_reduce_(errs) / engine.n       # pmean
        error_trace = errs.cpu().numpy().astype(np.float64)
    ledger = CommLedger()
    ledger.log_gossip_rounds(sched, engine.graph.adjacency, d * r)
    return SDOTResult(q_nodes=engine.group.all_gather(q),
                      error_trace=error_trace, consensus_trace=sched,
                      ledger=ledger)
