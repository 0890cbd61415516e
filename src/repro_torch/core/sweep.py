"""Monte-Carlo sweep engine over the runtime: the twin of
``repro/core/sweep.py``.

The paper's Figs. 4-6 average over random initializations, and its tables
sweep topologies and consensus schedules. Each sweep here is one
``runtime.Program`` over a grid of lanes, cases x seeds:

* the **seed axis** carries one orthonormal init a seed;
* the **case axis** stacks the cases' weights, debias tables and
  schedules; heterogeneous graphs stack as long as they share the node
  count;
* **ragged node counts** (ER N=10 beside ring N=20) stack too:
  ``sdot_sweep`` / ``baseline_sweep`` (dsa / dpgd / deepca) pad each case's
  covs to N_max with isolated identity nodes (block-diag(W, I) weights,
  identity covs, a node-masked error trace); ``fdot_sweep`` pads with
  all-zero slabs, which need no mask (``sweep_utils``).

The reference vmaps each family's own scan body over the grid. The port's
kernels are launched through ``ctypes``, which ``torch.func.vmap`` cannot
batch, so each family has a lane body over an explicit (C, S, ...) carry
(``core/sdot``, ``core/fdot``, ``core/baselines``): every gossip round is
one batched matmul over the lanes, each case's lanes are held fixed past
their own budget (the reference's masked scan), each lane is debiased by
its own case's table row, the Gram kernel takes every lane's CholeskyQR in
one launch, and the gram-apply and slab kernels, which read one X for
every lane, take them through ``kernels/ops``' lane dispatch (the slab tq
kernel with the lanes folded into its columns, the others one launch a
lane).

Sweeps are ordinary Programs, so ``manager`` / ``chunk_size`` run them
through the chunked driver: a sweep killed at a chunk boundary resumes
mid-grid with the bits of the uninterrupted sweep.

Inits. The reference draws seed s's init from ``jax.random.PRNGKey(s)``;
the port from ``torch.Generator().manual_seed(s)`` on the CPU (the same on
every device), and ``q_inits`` (S, d, r) injects the reference's own.
A lane of a sweep is the port's own single run from the same init, to
float tolerance (the lanes' batched products sum in other orders).
``netfault_sweep`` gives lane (case c, seed s) the fault stream of seed
``netfault_lane_seed(engines[c].seed, s)``: a function of the seed's value,
not its place in the grid, so a shard computes the lanes the full grid
computes at its seeds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import runtime
from .baselines import (_d_pm_build_body, _deepca_build_body,
                        _dsa_build_body, _seq_dist_pm_build_body)
from .consensus import DenseConsensus, consensus_schedule, debias_table
from .fdot import (QR_PASSES, _fdot_lane_build_body, pad_feature_slabs,
                   split_pad_rows)
from .linalg import orthonormal_init
from .metrics import CommLedger
from .sdot import _sdot_lane_build_body, _stack_data, local_cov_apply
from .sweep_utils import (broadcast_per_case, case_node_masks,
                          pad_covs_identity, pad_weights_identity,
                          pad_zero_nodes)

__all__ = ["SweepResult", "sdot_sweep", "fdot_sweep", "baseline_sweep",
           "netfault_sweep", "slice_seed_shards", "netfault_lane_seed"]

_SEED_MASK = (1 << 63) - 1


def slice_seed_shards(seeds: Sequence[int], n_shards: int) -> list:
    """Slice the Monte-Carlo seed axis into contiguous shards, one a
    worker's lease: concatenating the shards' results along the seed axis
    gives the single-process sweep's seed order. ``n_shards`` is clamped to
    the seed count, so no shard is empty."""
    seeds = [int(s) for s in seeds]
    n_shards = max(1, min(int(n_shards), len(seeds)))
    return [list(map(int, s))
            for s in np.array_split(np.asarray(seeds), n_shards)]


def netfault_lane_seed(engine_seed: int, seed: int) -> int:
    """The fault stream's seed of a ``netfault_sweep`` lane: the case
    engine's seed and the Monte-Carlo seed's value mixed through NumPy's
    SeedSequence (the port's twin of the reference's ``fold_in``). A
    per-seed run of ``FaultyConsensus(..., seed=netfault_lane_seed(e, s))``
    draws the lane's blocks."""
    state = np.random.SeedSequence(
        [int(engine_seed) & _SEED_MASK, int(seed) & _SEED_MASK])
    return int(state.generate_state(1, np.uint64)[0]) & _SEED_MASK


@dataclasses.dataclass
class SweepResult:
    """Stacked outputs of a Monte-Carlo sweep.

    ``q`` and ``error_traces`` lead with the case axis C (only when the
    sweep ran several cases) and the seed axis S. ``node_counts`` is set by
    ragged sweeps: only the first ``node_counts[c]`` nodes of ``q[c]`` are
    real. ``steps_done`` counts completed outer iterations (below t_outer
    for a chunked sweep killed mid-grid) and ``resumed_step`` is the step
    the restored RunState carried (0: a fresh start).
    """

    q: torch.Tensor
    error_traces: Optional[np.ndarray]
    ledger: CommLedger
    seeds: np.ndarray
    node_counts: Optional[np.ndarray] = None
    steps_done: Optional[int] = None
    resumed_step: int = 0
    resume_report: Optional[dict] = None

    def _traces(self) -> np.ndarray:
        if self.error_traces is None:
            raise ValueError("sweep ran without q_true — no error traces "
                             "were recorded")
        return self.error_traces

    @property
    def mean_trace(self) -> np.ndarray:
        """Monte-Carlo mean over the seed axis."""
        return self._traces().mean(axis=-2)

    @property
    def std_trace(self) -> np.ndarray:
        return self._traces().std(axis=-2)

    @classmethod
    def merge_shards(cls, trees: Sequence[dict], *, n_cases: int,
                     has_err: bool, ragged: bool,
                     resume_report: Optional[dict] = None) -> "SweepResult":
        """Merge per-shard result trees (``q``, ``seeds``, ``ledger``, and
        ``error_traces`` / ``node_counts`` / ``spec_fp`` where present) in
        shard order along the seed axis.

        Refused, not concatenated: shards published under different spec
        fingerprints (a workdir reused across sweep configurations), and
        shards whose seeds overlap (shard files of two partitionings):
        either would give a result that no single sweep gives."""
        fps = sorted({int(np.asarray(tree["spec_fp"])) for tree in trees
                      if "spec_fp" in tree})
        if len(fps) > 1:
            raise ValueError(
                "merge_shards: shards come from different sweep specs "
                f"(spec fingerprints {fps}) — refusing to merge results "
                "of different configurations")
        seen = {}
        for i, tree in enumerate(trees):
            for s in np.asarray(tree["seeds"]).reshape(-1).tolist():
                s = int(s)
                if s in seen:
                    raise ValueError(
                        f"merge_shards: seed {s} appears in shard "
                        f"{seen[s]} and shard {i} — overlapping seed "
                        "slices (mixed shard partitionings?)")
                seen[s] = i
        seed_axis = 1 if n_cases > 1 else 0
        qs, errs, seeds, node_counts = [], [], [], None
        ledger = CommLedger()
        for tree in trees:
            qs.append(torch.as_tensor(np.asarray(tree["q"])))
            seeds.append(np.asarray(tree["seeds"]))
            ledger = ledger.merged(tree["ledger"])
            if has_err:
                errs.append(np.asarray(tree["error_traces"]))
            if ragged:
                node_counts = np.asarray(tree["node_counts"])
        return cls(
            q=torch.cat(qs, dim=seed_axis),
            error_traces=(np.concatenate(errs, axis=seed_axis)
                          if has_err else None),
            ledger=ledger, seeds=np.concatenate(seeds),
            node_counts=node_counts, resume_report=resume_report)


def _seed_inits(seeds: Sequence[int], d: int, r: int, q_inits,
                device: torch.device) -> torch.Tensor:
    """(S, d, r) inits: ``q_inits`` if given, else one draw of
    ``torch.Generator().manual_seed(s)`` a seed."""
    if q_inits is not None:
        q = torch.as_tensor(q_inits).to(device, torch.float32)
        if q.shape != (len(seeds), d, r):
            raise ValueError(f"q_inits must be ({len(seeds)}, {d}, {r}), "
                             f"got {tuple(q.shape)}")
        return q
    return torch.stack([
        orthonormal_init(torch.Generator().manual_seed(int(s)), d, r,
                         device=device) for s in seeds])


def _broadcast_cases(engines, schedules, t_outer, t_c, allow_ragged=False):
    """Zip-broadcast engines x schedules into C aligned cases."""
    engines = (list(engines) if isinstance(engines, (list, tuple))
               else [engines])
    if schedules is None:
        schedules = [consensus_schedule("const", t_outer, t_max=t_c)]
    elif isinstance(schedules, np.ndarray) and schedules.ndim == 1:
        schedules = [schedules]
    schedules = [np.asarray(s) for s in schedules]
    for s in schedules:
        if len(s) < t_outer:
            raise ValueError(f"schedule has {len(s)} entries but "
                             f"t_outer={t_outer}")
    c = max(len(engines), len(schedules))
    if len(engines) == 1:
        engines = engines * c
    if len(schedules) == 1:
        schedules = schedules * c
    if len(engines) != len(schedules):
        raise ValueError("engines and schedules must zip-broadcast: got "
                         f"{len(engines)} vs {len(schedules)}")
    n_nodes = engines[0].graph.n_nodes
    if not allow_ragged and any(e.graph.n_nodes != n_nodes for e in engines):
        raise ValueError("all sweep engines must share the node count")
    return engines, [s[:t_outer] for s in schedules]


def _reject_sparse(engines) -> None:
    """Sweeps stack dense (C, N, N) weights; sparse engines are refused."""
    if any(getattr(e, "is_sparse", False) for e in engines):
        raise ValueError(
            "sweeps require dense engines: construct with sparse=False "
            "(SparseW-backed engines are not vmappable across cases yet)")


def _sweep_device(engines, device) -> torch.device:
    dev = engines[0].device if device is None else torch.device(device)
    if any(e.device != dev for e in engines):
        raise ValueError(f"every sweep engine must live on {dev}")
    return dev


def _case_stacks(engines, t_max):
    _reject_sparse(engines)
    ws = torch.stack([e._w for e in engines])
    tables = torch.stack([debias_table(e._w, t_max) for e in engines])
    return ws, tables


def _ragged_stacks(engines, t_max, device):
    """Identity-padded (C, N_max, N_max) weights, their debias tables and
    (C, N_max) node masks for a mixed-node-count case axis."""
    _reject_sparse(engines)
    n_list = [e.graph.n_nodes for e in engines]
    n_max = max(n_list)
    ws = torch.stack([torch.as_tensor(
        pad_weights_identity(e.weights, n_max).astype(np.float32),
        device=device) for e in engines])
    tables = torch.stack([debias_table(w, t_max) for w in ws])
    masks = case_node_masks(n_list, n_max, device)
    return ws, tables, masks, n_list, n_max


def _check_case_covs(case_covs, engines):
    for c, e in zip(case_covs, engines):
        if c.shape[0] != e.graph.n_nodes:
            raise ValueError("per-case covs must match each engine's node "
                             f"count: got {c.shape[0]} covs for an "
                             f"{e.graph.n_nodes}-node graph")


def _lane_q0(q0: torch.Tensor, n_cases: int) -> torch.Tensor:
    """(S, ...) per-seed carry -> (C, S, ...) lanes."""
    return q0[None].expand(n_cases, *q0.shape).contiguous()


def _lane_ledger(ledger: CommLedger, engines, n_seeds: int, rounds,
                 payload: int) -> None:
    """The closed-form ledger of every lane: each case's rounds, once a
    seed."""
    for eng, sched in zip(engines, rounds):
        for _ in range(n_seeds):
            ledger.log_gossip_rounds(sched, eng.graph.adjacency, payload,
                                     eng.payload_bytes_per_elem)


def _sweep_result(state, done, *, q_map, trace_err, single_case, ledger,
                  seeds, node_counts=None):
    def squeeze(a):
        return a[0] if single_case else a
    return SweepResult(
        q=squeeze(q_map(state.q)),
        error_traces=(squeeze(state.errs[..., :done].cpu().numpy().copy())
                      if trace_err else None),
        ledger=ledger, seeds=np.asarray([int(s) for s in seeds]),
        node_counts=node_counts, steps_done=done)


def _run_sweep(build, operands, statics, xs, q0, case_axes, n_cases,
               n_seeds, finalize, manager, chunk_size, max_chunks,
               key0=None, tail=(), node_mask=None):
    """Assemble the sweep Program and hand it to the runtime."""
    program = runtime.Program(
        build_body=build, operands=operands, statics=statics, xs=xs, q0=q0,
        key0=key0, tail=tail, case_axes=case_axes, n_cases=n_cases,
        n_seeds=n_seeds, node_mask=node_mask, finalize=finalize)
    result = runtime.run_sweep(program, manager=manager,
                               chunk_size=chunk_size, max_chunks=max_chunks)
    result.resumed_step = program.restored_step
    return result


def _step_body(operands, *, inner, **statics):
    """A one-case sweep of a sequential-deflation baseline: every lane
    takes the same step index, the one case's entry of the (1,) input."""
    body = inner(operands, **statics)
    return lambda carry_key, x: body(carry_key, int(x[0]))


def sdot_sweep(
    *,
    covs=None,
    data: Optional[Sequence[torch.Tensor]] = None,
    engines: Union[DenseConsensus, Sequence[DenseConsensus]],
    r: int,
    t_outer: int,
    schedules=None,
    t_c: int = 50,
    seeds: Sequence[int] = (0,),
    q_true: Optional[torch.Tensor] = None,
    q_inits: Optional[torch.Tensor] = None,
    device=None,
    manager=None,
    chunk_size: Optional[int] = None,
    max_chunks: Optional[int] = None,
) -> SweepResult:
    """Monte-Carlo S-DOT/SA-DOT: seeds x (topology, schedule) cases.

    ``engines`` / ``schedules`` zip-broadcast into the case axis. ``covs``
    is one (N, d, d) stack shared by every case, or a list with one
    (N_c, d, d) stack a case (mixed node counts pad with isolated identity
    nodes, and the result carries ``node_counts``); ``data`` (raw (d, n_i)
    blocks, shared) runs Step 5 through the gram-apply kernel.
    ``manager`` / ``chunk_size`` run the sweep through the chunked driver.
    """
    if (covs is None) == (data is None):
        raise ValueError("provide exactly one of covs / data")
    per_case_covs = covs is not None and isinstance(covs, (list, tuple))
    engines, schedules = _broadcast_cases(engines, schedules, t_outer, t_c,
                                          allow_ragged=per_case_covs)
    dev = _sweep_device(engines, device)
    c_n, s_n = len(engines), len(list(seeds))
    t_max = int(max(int(s.max()) for s in schedules)) if t_outer else 0
    trace_err = q_true is not None
    q_arg = q_true.to(dev, torch.float32) if trace_err else None
    node_mask = None

    if per_case_covs:
        case_covs = broadcast_per_case(
            [torch.as_tensor(c).to(dev, torch.float32) for c in covs], c_n,
            "covs")
        _check_case_covs(case_covs, engines)
        d = int(case_covs[0].shape[1])
        ws, tables, masks, n_list, n = _ragged_stacks(engines, t_max, dev)
        operand = torch.stack([pad_covs_identity(c, n) for c in case_covs])
        case_axes = (0, 0, 0, None)
        mode = "cov"
        node_counts = np.asarray(n_list)
        node_mask = masks[:, None].expand(c_n, s_n, n)
    else:
        n = engines[0].graph.n_nodes
        ws, tables = _case_stacks(engines, t_max)
        if covs is not None:
            operand = torch.as_tensor(covs).to(dev, torch.float32)
            d = int(operand.shape[1])
            mode = "cov"
        else:
            if len(data) != n:
                raise ValueError("need one data block per node")
            operand = _stack_data(data, dev)
            d = int(data[0].shape[0])
            mode = "data"
        case_axes = (None, 0, 0, None)
        node_counts = None

    q0 = _seed_inits(seeds, d, r, q_inits, dev)                # (S, d, r)
    q0_nodes = q0[:, None].expand(s_n, n, d, r)
    ledger = CommLedger()

    def finalize(state, done):
        _lane_ledger(ledger, engines, s_n, [s[:done] for s in schedules],
                     d * r)
        return _sweep_result(state, done, q_map=lambda q: q,
                             trace_err=trace_err, single_case=c_n == 1,
                             ledger=ledger, seeds=seeds,
                             node_counts=node_counts)

    return _run_sweep(
        _sdot_lane_build_body, (operand, ws, tables, q_arg),
        (("mode", mode), ("t_max", t_max)),
        np.stack(schedules).astype(np.int64), _lane_q0(q0_nodes, c_n),
        case_axes, c_n, s_n, finalize, manager, chunk_size, max_chunks,
        node_mask=node_mask)


def netfault_sweep(
    *,
    covs,
    engines,
    r: int,
    t_outer: int,
    schedules=None,
    t_c: int = 50,
    seeds: Sequence[int] = (0,),
    q_true: Optional[torch.Tensor] = None,
    q_inits: Optional[torch.Tensor] = None,
    device=None,
    manager=None,
    chunk_size: Optional[int] = None,
    max_chunks: Optional[int] = None,
) -> SweepResult:
    """Monte-Carlo S-DOT/SA-DOT under network faults: seeds x
    (FaultyConsensus, schedule) cases.

    Each case is a ``FaultyConsensus`` engine: its fault knobs stack as
    (C, 6) lane data and its crash windows as a (C, T, N) node-up stack.
    Lane (c, s) draws the fault stream of ``netfault_lane_seed(
    engines[c].seed, s)`` from the engine's counter on, so a shard of the
    seeds computes the lanes the full grid computes there. All case
    engines share the node count and the ``debias`` mode. The burst state
    and step counter ride in the carry: a killed faulty sweep resumes
    mid-grid with the bits of the uninterrupted one.
    """
    if not isinstance(engines, (list, tuple)):
        engines = [engines]
    for e in engines:
        if not hasattr(e, "sample_faults"):
            raise ValueError("netfault_sweep needs FaultyConsensus engines")
    engines, schedules = _broadcast_cases(list(engines), schedules, t_outer,
                                          t_c)
    debias = engines[0].debias
    if any(e.debias != debias for e in engines):
        raise ValueError("all netfault_sweep engines must share the debias "
                         "mode (it is a compile-time static)")
    _reject_sparse(engines)
    dev = _sweep_device(engines, device)
    c_n, s_list = len(engines), [int(s) for s in seeds]
    s_n = len(s_list)
    n = engines[0].graph.n_nodes
    covs = torch.as_tensor(covs).to(dev, torch.float32)
    d = int(covs.shape[1])
    t_max = int(max(int(s.max()) for s in schedules)) if t_outer else 0
    trace_err = q_true is not None

    ws = torch.stack([e._w for e in engines])
    adjs = torch.stack([e._adj for e in engines])
    params = torch.stack([e._params for e in engines])          # (C, 6)
    node_up = torch.stack([torch.as_tensor(
        e.faults.validate(n, t_outer).node_up(t_outer, n), device=dev)
        for e in engines])                                      # (C, T, N)
    tables = (torch.stack([debias_table(e._w, t_max) for e in engines])
              if debias == "nominal" else None)
    operands = (covs, ws, adjs, params, node_up, tables,
                q_true.to(dev, torch.float32) if trace_err else None)
    case_axes = (None, 0, 0, 0, 0, 0 if tables is not None else None, None)

    q0 = _seed_inits(s_list, d, r, q_inits, dev)
    q0_nodes = q0[:, None].expand(s_n, n, d, r)
    ge0 = torch.zeros((s_n, n, n), dtype=torch.bool, device=dev)
    q0_lane = (_lane_q0(q0_nodes, c_n), _lane_q0(ge0, c_n),
               torch.zeros((c_n, s_n), dtype=torch.int32))
    key0 = torch.tensor([[[netfault_lane_seed(e.seed, s), int(e._key[1])]
                          for s in s_list] for e in engines],
                        dtype=torch.int64)                      # (C, S, 2)
    payload = d * r
    sched_stack = np.stack(schedules)

    def finalize(state, done):
        ledger = CommLedger()
        sends = state.sends[..., :done, :].cpu().numpy().astype(np.float64)
        counts = state.counts[..., :done, :].cpu().numpy()
        total = float(sends.sum())
        ledger.p2p += total
        ledger.matrices += total
        ledger.scalars += total * payload
        ledger.payload_bytes = (ledger.scalars
                                * engines[0].payload_bytes_per_elem)
        for c in range(c_n):
            for s_i in range(s_n):
                for t in range(done):
                    ledger.log_awake_rounds(
                        counts[c, s_i, t][:int(sched_stack[c][t])])
        return _sweep_result(state, done, q_map=lambda q: q[0],
                             trace_err=trace_err, single_case=c_n == 1,
                             ledger=ledger, seeds=s_list)

    return _run_sweep(
        _sdot_lane_build_body, operands,
        (("mode", "cov"), ("t_max", t_max), ("kind", "faulty"),
         ("debias", debias)),
        sched_stack.astype(np.int64), q0_lane, case_axes, c_n, s_n,
        finalize, manager, chunk_size, max_chunks, key0=key0, tail=(t_max,))


def fdot_sweep(
    *,
    data_blocks: Sequence,
    engines: Union[DenseConsensus, Sequence[DenseConsensus]],
    r: int,
    t_outer: int,
    schedules=None,
    t_c: int = 50,
    t_c_qr: Optional[int] = None,
    seeds: Sequence[int] = (0,),
    q_true: Optional[torch.Tensor] = None,
    q_inits: Optional[torch.Tensor] = None,
    device=None,
    manager=None,
    chunk_size: Optional[int] = None,
    max_chunks: Optional[int] = None,
) -> SweepResult:
    """Monte-Carlo F-DOT over padded feature slabs (the Fig. 6 axis).

    ``data_blocks`` is one slab list shared by every case, or a list of
    slab lists, one a case (different partitionings of the same d
    features; mixed node counts pad with all-zero slabs, and the result
    carries ``node_counts``). ``manager`` / ``chunk_size`` as in
    ``sdot_sweep``.
    """
    per_case = (len(data_blocks) > 0
                and isinstance(data_blocks[0], (list, tuple)))
    engines, schedules = _broadcast_cases(engines, schedules, t_outer, t_c,
                                          allow_ragged=per_case)
    dev = _sweep_device(engines, device)
    c_n, s_n = len(engines), len(list(seeds))
    t_c_qr = int(t_c if t_c_qr is None else t_c_qr)
    t_max = int(max(max(int(s.max()) for s in schedules), t_c_qr))
    trace_err = q_true is not None
    if trace_err:
        q_true = q_true.to(dev, torch.float32)

    def f32(blocks):
        return [torch.as_tensor(x).to(dev, torch.float32) for x in blocks]

    if per_case:
        case_blocks = broadcast_per_case(data_blocks, c_n, "data_blocks")
        n_list = []
        for blocks, e in zip(case_blocks, engines):
            if len(blocks) != e.graph.n_nodes:
                raise ValueError("per-case data_blocks must match each "
                                 f"engine's node count: got {len(blocks)} "
                                 f"slabs for an {e.graph.n_nodes}-node graph")
            n_list.append(e.graph.n_nodes)
        case_dims = [[int(x.shape[0]) for x in blocks]
                     for blocks in case_blocks]
        d = sum(case_dims[0])
        if any(sum(dims) != d for dims in case_dims):
            raise ValueError("every case must partition the same d features")
        n_samples = int(case_blocks[0][0].shape[1])
        ws, tables, _, _, n_max = _ragged_stacks(engines, t_max, dev)
        d_slab = max(max(dims) for dims in case_dims)

        def pad_case(stack):
            rows = stack.new_zeros((stack.shape[0],
                                    d_slab - stack.shape[1],
                                    *stack.shape[2:]))
            return pad_zero_nodes(torch.cat([stack, rows], dim=1), n_max)

        x_pad = torch.stack([pad_case(pad_feature_slabs(f32(blocks)))
                             for blocks in case_blocks])  # (C, N, d, n)
        q_seeds = _seed_inits(seeds, d, r, q_inits, dev)
        q0 = torch.stack([
            torch.stack([pad_case(split_pad_rows(q, dims)) for q in q_seeds])
            for dims in case_dims])                       # (C, S, N, d, r)
        qtrue_pad = (torch.stack([pad_case(split_pad_rows(q_true, dims))
                                  for dims in case_dims])
                     if trace_err else None)
        case_axes = (0, 0, 0, 0 if trace_err else None)
        node_counts = np.asarray(n_list)
    else:
        n_nodes = engines[0].graph.n_nodes
        if len(data_blocks) != n_nodes:
            raise ValueError("need one feature slab per node")
        dims = [int(x.shape[0]) for x in data_blocks]
        d = sum(dims)
        n_samples = int(data_blocks[0].shape[1])
        ws, tables = _case_stacks(engines, t_max)
        x_pad = pad_feature_slabs(f32(data_blocks))
        q0 = _lane_q0(torch.stack([
            split_pad_rows(q, dims)
            for q in _seed_inits(seeds, d, r, q_inits, dev)]), c_n)
        qtrue_pad = split_pad_rows(q_true, dims) if trace_err else None
        case_axes = (None, 0, 0, None)
        node_counts = None

    ledger = CommLedger()

    def finalize(state, done):
        _lane_ledger(ledger, engines, s_n, [s[:done] for s in schedules],
                     n_samples * r)
        _lane_ledger(ledger, engines, s_n,
                     [np.full(done, QR_PASSES * t_c_qr)] * c_n, r * r)
        return _sweep_result(state, done, q_map=lambda q: q,
                             trace_err=trace_err, single_case=c_n == 1,
                             ledger=ledger, seeds=seeds,
                             node_counts=node_counts)

    return _run_sweep(
        _fdot_lane_build_body, (x_pad, ws, tables, qtrue_pad),
        (("t_c_qr", t_c_qr),),
        np.stack(schedules).astype(np.int64), q0, case_axes, c_n, s_n,
        finalize, manager, chunk_size, max_chunks)


def baseline_sweep(
    name: str,
    *,
    covs=None,
    data_blocks: Optional[Sequence[torch.Tensor]] = None,
    engine: Optional[DenseConsensus] = None,
    engines=None,
    r: int,
    seeds: Sequence[int] = (0,),
    q_true: Optional[torch.Tensor] = None,
    q_inits: Optional[torch.Tensor] = None,
    t_outer: Optional[int] = None,
    iters_per_vec: Optional[int] = None,
    lr: float = 0.1,
    t_mix: int = 3,
    t_c: int = 50,
    device=None,
    manager=None,
    chunk_size: Optional[int] = None,
    max_chunks: Optional[int] = None,
) -> SweepResult:
    """Monte-Carlo sweep of one fused baseline over seeds.

    ``name``: dsa | dpgd | deepca (sample-partitioned, ``covs`` +
    ``t_outer``), seq_dist_pm (``covs`` + ``iters_per_vec``), or d_pm
    (feature-partitioned, ``data_blocks`` + ``iters_per_vec``). The cov
    trio also takes ``engines`` (a list) with per-case ``covs`` of mixed
    node counts (identity padding, as ``sdot_sweep``); the result then
    carries a case axis and ``node_counts``. The sequential-deflation
    baselines are single-case only.
    """
    if engines is not None and engine is not None:
        raise ValueError("pass engine or engines, not both")
    engine_list = None
    if engines is not None:
        if isinstance(engines, (list, tuple)):
            engine_list = list(engines)
        else:
            engine = engines
    if engine is None and engine_list is None:
        raise ValueError("baseline_sweep needs an engine")

    trace_err = q_true is not None
    s_n = len(list(seeds))
    node_counts, squeeze_node_counts = None, False

    if engine_list is not None:
        if name not in ("dsa", "dpgd", "deepca"):
            raise ValueError(f"{name} does not support a ragged-N case axis "
                             "(sequential-deflation baselines are "
                             "single-case only)")
        if covs is None or t_outer is None:
            raise ValueError(f"{name} sweep needs covs and t_outer")
        dev = _sweep_device(engine_list, device)
        if not isinstance(covs, (list, tuple)):
            covs = [covs]
        case_covs = broadcast_per_case(
            [torch.as_tensor(c).to(dev, torch.float32) for c in covs],
            len(engine_list), "covs")
        _check_case_covs(case_covs, engine_list)
        ws, _, masks, n_list, n_max = _ragged_stacks(engine_list, 0, dev)
        case_covs = torch.stack([pad_covs_identity(c, n_max)
                                 for c in case_covs])      # (C, N, d, d)
        node_counts = np.asarray(n_list)
        squeeze_node_counts = len(engine_list) == 1
    else:
        engine_list = [engine]
        dev = _sweep_device(engine_list, device)
        if name in ("dsa", "dpgd", "deepca") and (covs is None
                                                  or t_outer is None):
            raise ValueError(f"{name} sweep needs covs and t_outer")
        _reject_sparse(engine_list)
        ws = engine._w[None]
        n_max = engine.graph.n_nodes
        masks = torch.ones((1, n_max), dtype=torch.float32, device=dev)
        if covs is not None:
            case_covs = torch.as_tensor(covs).to(dev, torch.float32)[None]

    c_n = len(engine_list)
    if trace_err:
        q_true = q_true.to(dev, torch.float32)
    ledger = CommLedger()
    lane_ops = lambda *ops: tuple(  # noqa: E731
        None if o is None else o[:, None] for o in ops)

    if name in ("dsa", "dpgd", "deepca"):
        d = int(case_covs.shape[2])
        q0 = _seed_inits(seeds, d, r, q_inits, dev)
        q0_lane = _lane_q0(q0[:, None].expand(s_n, n_max, d, r), c_n)
        xs = np.zeros((c_n, t_outer), np.int64)
        covs_l, ws_l, masks_l = lane_ops(case_covs, ws, masks)
        if name == "deepca":
            build, statics = _deepca_build_body, (("t_mix", t_mix),)
            s0 = local_cov_apply(covs_l, q0_lane)
            q0_lane = (q0_lane, s0, s0)
            operands = (covs_l, ws_l, q_true, masks_l)
            case_axes = (0, 0, None, 0)
            rounds = lambda done: np.full(done, t_mix)     # noqa: E731
        else:
            build, statics = _dsa_build_body, (("name", name),)
            operands = (covs_l, ws_l, lr, q_true, masks_l)
            case_axes = (0, 0, None, None, 0)
            rounds = lambda done: np.ones(done)            # noqa: E731
        q_map = (lambda c: c[0]) if name == "deepca" else (lambda q: q)
        payload = d * r
    elif name in ("seq_dist_pm", "d_pm"):
        if iters_per_vec is None or (covs is None) == (data_blocks is None):
            raise ValueError(f"{name} sweep needs iters_per_vec and "
                             "covs (seq_dist_pm) / data_blocks (d_pm)")
        statics = (("r", r), ("iters_per_vec", iters_per_vec), ("t_c", t_c))
        xs = np.arange(r * iters_per_vec, dtype=np.int64)[None]
        rounds = lambda done: np.full(done, t_c)           # noqa: E731
        table = engine.debias_table(t_c)
        if name == "seq_dist_pm":
            covs_s = case_covs[0]
            n, d, _ = covs_s.shape
            q0 = _seed_inits(seeds, d, r, q_inits, dev)       # (S, d, r)
            q0_lane = _lane_q0(q0.mT[:, :, None, :].expand(s_n, r, n, d)
                               .contiguous(), 1)           # (1, S, r, N, d)
            inner = _seq_dist_pm_build_body
            operands = (covs_s, engine._w, table, q_true)
            q_map = lambda cols: cols.permute(0, 1, 3, 4, 2)  # noqa: E731
            payload = d
        else:
            blocks = [torch.as_tensor(x).to(dev, torch.float32)
                      for x in data_blocks]
            dims = [int(x.shape[0]) for x in blocks]
            d = sum(dims)
            x_pad = pad_feature_slabs(blocks)
            q0_pad = torch.stack([split_pad_rows(q, dims) for q in
                                  _seed_inits(seeds, d, r, q_inits, dev)])
            q0_lane = _lane_q0(q0_pad.permute(0, 3, 1, 2).contiguous(), 1)
            inner = _d_pm_build_body
            operands = (x_pad, engine._w, table,
                        split_pad_rows(q_true, dims) if trace_err else None)
            # blocks: (C, S, r, N, d_max) -> concatenated (C, S, d, r)
            q_map = lambda b: torch.cat(                       # noqa: E731
                [b[:, :, :, i, :di].mT for i, di in enumerate(dims)], dim=2)
            payload = int(blocks[0].shape[1])                  # n_samples
        build, statics = _step_body, (("inner", inner),) + statics
        case_axes = (None,) * len(operands)
    else:
        raise ValueError(f"unknown baseline: {name}")

    def finalize(state, done):
        _lane_ledger(ledger, engine_list, s_n, [rounds(done)] * c_n,
                     payload)
        return _sweep_result(
            state, done, q_map=q_map, trace_err=trace_err,
            single_case=c_n == 1, ledger=ledger, seeds=seeds,
            node_counts=None if squeeze_node_counts else node_counts)

    return _run_sweep(build, operands, statics, xs, q0_lane, case_axes,
                      c_n, s_n, finalize, manager, chunk_size, max_chunks)
