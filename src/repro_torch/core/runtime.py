"""Unified executor runtime: one Program protocol, generic drivers.

The twin of ``repro/core/runtime.py``. Every fused family (S-DOT/SA-DOT,
F-DOT, B-DOT) registers its run as a ``Program``, and the drivers execute
any Program:

* ``run_monolithic``: the whole run as one chunk, the fused default path
  of ``sdot`` / ``fdot`` / ``bdot``;
* ``run_chunked``: ``chunk_size`` outer iterations at a time, with the
  ``RunState`` checkpointed through a ``CheckpointManager`` at every chunk
  boundary; a run killed at any boundary and resumed gives the same bits
  as the uninterrupted run (the trace, the iterate and the ledger);
* ``run_sweep``: a case x seed grid (``core/sweep.py``), monolithic or
  chunked like the two above. The reference vmaps one run's body over the
  grid; the port's kernels are launched through ``ctypes``, which
  ``torch.func.vmap`` cannot batch, so a sweep's body is the family's lane
  body over an explicit (C, S, ...) carry, and every ``RunState`` buffer
  carries the (C, S) lane axes in front (the reference's layout).

A Program is ``(build_body, operands, statics, xs, q0, ...)``:

* ``build_body(operands, **statics) -> body`` is a module-level builder
  returning one outer step, the unified body
  ``body((carry, key), t_c) -> ((carry', key'), (cross, sends, counts))``.
  ``carry`` is the family's iterate (an (N, d, r) stack for S-DOT, padded
  slabs for F-DOT/B-DOT, an (iterate, Gilbert-Elliott state, step) triple
  for the net-fault programs). ``cross`` is the step's Q_true^T Q cross
  products (..., r, r), or None without a ground truth. Synchronous
  families lift a body ``(carry, t_c) -> (carry', cross)`` through
  ``sync_body``: the key threads through untouched and sends/counts are
  None. Asynchronous and faulty families take their draws from the key
  (``async_gossip.GossipDraws``: the (2,) int64 ``[seed, counter]``) and
  return their realized per-round sends and awake counts, each of shape
  ``Program.tail``.
* ``xs`` is the host-side schedule: step t runs exactly ``xs[t]`` gossip
  rounds, as the reference's masked scan does. A sweep's ``xs`` is (C, T):
  its body gets the (C,) budgets of a step and holds each case's lanes
  fixed past their own budget.

A chunk is a Python loop over the body: the body launches work on the
device and never waits for it. At the end of a chunk each step's error,
the mean over its cross products of eq. (11), comes from one batched SVD
call for the whole chunk (every CUDA SVD in PyTorch waits for the device,
so none runs inside the loop) and an element-wise sum over the nodes.
The trace's bits then do not depend on where the chunk boundaries fall,
because cuSOLVER's singular values of a matrix do not depend on the batch
it is in: checked on the H100 by chip_smoke.py's ``resume`` phase every
run (CPU LAPACK takes the matrices one by one). The trace is written into
``RunState.errs`` in place; the manager copies a snapshot to the host
before the next chunk starts.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
import zipfile
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import _tree
from ..checkpoint.manager import CheckpointManager
from ..obs import get_journal
from .metrics import CommLedger, subspace_error_from_cross

__all__ = ["RunState", "Program", "sync_body", "step_errors",
           "run_monolithic", "run_chunked", "run_sweep", "async_ledger"]


def sync_body(inner: Callable) -> Callable:
    """Lift a synchronous outer body ``(carry, t_c) -> (carry', cross)``
    into the unified signature: the key threads through untouched and the
    step has no sends or counts."""

    def body(carry_key, t_c):
        carry, key = carry_key
        carry, cross = inner(carry, t_c)
        return (carry, key), (cross, None, None)

    return body


@dataclasses.dataclass
class RunState:
    """Everything a run needs to continue from a chunk boundary.

    The leaves keep the reference's order and names (``0`` ... ``5`` in a
    checkpoint), so the port restores a step the reference wrote for a sync
    run and the reverse. A sync run's ``key``, ``sends`` and ``counts`` are
    the zeros the reference writes (() uint32, (T_o,), (T_o,)). An async
    run's key is the port's own (2,) int64 ``[seed, counter]``, and its
    sends and counts are (T_o, *tail): the realized ledger survives a
    crash. A reference async checkpoint, whose key is a JAX key, is
    refused. A sweep's buffers carry the (C, S) lane axes in front, as the
    reference's do: a sync sweep the reference checkpointed restores here.
    """

    q: Any                    # the family's carry (iterate, slabs, ...)
    key: torch.Tensor         # host: (lanes...) uint32 zeros, or
                              # (lanes..., 2) int64 keys
    step: torch.Tensor        # () int32 on the host: outer steps completed
    errs: torch.Tensor        # (lanes..., T_o) f32 error trace
    sends: torch.Tensor       # (lanes..., T_o, *tail) f32 per-round sends
    counts: torch.Tensor      # (lanes..., T_o, *tail) f32 awake counts


_tree.register_node(
    RunState,
    lambda s: ((s.q, s.key, s.step, s.errs, s.sends, s.counts), None),
    lambda _aux, children: RunState(*children))


@dataclasses.dataclass
class Program:
    """One family's run, in the form every driver understands.

    Families build these with ``core/sdot.sdot_program``,
    ``core/fdot.fdot_program``, ``core/bdot.bdot_program`` and
    ``core/baselines.baseline_program``, from the same prepared inputs as
    their eager oracles; ``core/sweep.py`` builds the sweeps'.

    A sweep sets ``n_cases`` and ``n_seeds``: ``q0`` and ``key0`` then lead
    with (C, S), ``xs`` is (C, T), and ``case_axes`` says, operand by
    operand, whether it is stacked by case (0) or shared by every lane
    (None). ``node_mask`` (C, S, N) keeps padded nodes out of a ragged
    sweep's mean over the nodes.
    """

    build_body: Callable      # module-level: (operands, **statics) -> body
    operands: Tuple           # tensors the body closes over
    statics: Tuple            # ((name, value), ...) for build_body
    xs: np.ndarray            # (T_o,) or (C, T_o) host-side schedule
    q0: Any                   # initial carry (lanes leading in sweeps)
    key0: Optional[torch.Tensor] = None   # async key; None: a sync run
    tail: Tuple[int, ...] = ()            # per-step sends/counts shape
    case_axes: Optional[Tuple] = None     # per operand: 0 by case, None
    n_cases: int = 0          # 0: no case axis; else leading C on q0/xs
    n_seeds: int = 0          # 0: no seed axis; else next S axis on q0
    node_mask: Optional[torch.Tensor] = None   # (C, S, N): ragged sweeps
    finalize: Optional[Callable] = None   # (state, done) -> family result
    restored_step: int = 0    # set by the driver: the step restored from
                              # the manager (0 = fresh start)

    @property
    def t_outer(self) -> int:
        return int(self.xs.shape[-1])

    @property
    def lane_shape(self) -> Tuple[int, ...]:
        return tuple(n for n in (self.n_cases, self.n_seeds) if n)


def step_errors(crosses: List[torch.Tensor], lanes: int = 0,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each step's error: eq. (11) of its cross products, averaged over the
    nodes where a step has one cross product a node (S-DOT; F-DOT, B-DOT
    and the baselines have one). ``crosses``: one (lanes..., [N,] r, r)
    tensor a step; ``lanes`` counts the leading lane axes. One SVD call for
    the chunk; the node mean adds the nodes' columns one at a time, element
    by element, so a step's sum is the same whatever else shares its chunk
    and the chunk costs N launches, not one a step. ``node_mask``
    (lanes..., N) weights each node (a ragged sweep's padding gets 0); with
    a mask of ones the sum and its divisor are those of the unmasked mean.
    """
    errs = subspace_error_from_cross(torch.stack(crosses))
    if errs.dim() == 1 + lanes:                  # (L, lanes...)
        return errs
    if node_mask is None:                        # (L, lanes..., N)
        total = errs[..., 0]
        for k in range(1, errs.shape[-1]):
            total = total + errs[..., k]
        return total / errs.shape[-1]
    m = node_mask.to(errs.device, errs.dtype)
    total = errs[..., 0] * m[..., 0]
    for k in range(1, errs.shape[-1]):
        total = total + errs[..., k] * m[..., k]
    return total / m.sum(dim=-1)


def _chunk(state: RunState, body: Callable, xs: np.ndarray,
           lanes: int = 0, node_mask: Optional[torch.Tensor] = None
           ) -> RunState:
    """Advance ``state`` by the ``xs.shape[-1]`` steps of ``xs`` (T,) or
    (C, T): a sweep's body takes each step's (C,) budgets."""
    carry, key = state.q, state.key
    crosses, sends, counts = [], [], []
    steps = xs.shape[-1]
    for t in range(steps):
        x = int(xs[t]) if xs.ndim == 1 else xs[:, t].astype(np.int64)
        (carry, key), (cross, s, c) = body((carry, key), x)
        if cross is not None:
            crosses.append(cross)
        if s is not None:
            sends.append(s)
            counts.append(c)
    begin = int(state.step)
    end = begin + steps
    # the step axis sits after the lane axes in every buffer
    if crosses:
        errs = step_errors(crosses, lanes, node_mask).movedim(0, -1)
        state.errs[..., begin:end] = errs.to(state.errs.device)
    if sends:
        at = (slice(None),) * lanes + (slice(begin, end),)
        state.sends[at] = torch.stack(sends).movedim(0, lanes)
        state.counts[at] = torch.stack(counts).movedim(0, lanes)
    return dataclasses.replace(state, q=carry, key=key,
                               step=torch.tensor(end, dtype=torch.int32))


def _init_state(program: Program) -> RunState:
    dev = _tree.tree_leaves(program.q0)[0].device
    lanes = program.lane_shape
    shape = lanes + (program.t_outer,) + tuple(program.tail)
    return RunState(
        q=program.q0,
        key=(torch.zeros(lanes, dtype=torch.uint32) if program.key0 is None
             else program.key0.clone()),
        step=torch.zeros((), dtype=torch.int32),
        errs=torch.zeros(lanes + (program.t_outer,), dtype=torch.float32,
                         device=dev),
        sends=torch.zeros(shape, dtype=torch.float32, device=dev),
        counts=torch.zeros(shape, dtype=torch.float32, device=dev))


def _restore_any(manager: Optional[CheckpointManager], like: RunState):
    """The newest restorable snapshot, skipping corrupt or half-written
    steps and snapshots whose buffers do not fit this run; None if there is
    none."""
    if manager is None:
        return None
    steps = manager.all_steps()
    for step in reversed(steps):
        try:
            state, _ = manager.restore(like, step=step)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile):
            continue                   # torn or corrupt: try an older step
        # names match, but a run with another t_outer or engine size has
        # buffers of other shapes: never resume into those
        if all(a.shape == b.shape for a, b in zip(
                _tree.tree_leaves(state), _tree.tree_leaves(like))):
            if state.key.dtype != like.key.dtype:
                # same shapes, another key: the reference's (2,) uint32
                # JAX key, whose stream the port cannot continue
                raise ValueError(
                    f"checkpoint step {step} in {manager.root} holds a "
                    f"{state.key.dtype} RNG key of shape "
                    f"{tuple(state.key.shape)}, not the port's "
                    f"{like.key.dtype} [seed, counter]: an async run of the "
                    "JAX reference, whose jax.random stream the port cannot "
                    "continue; resume it with the reference or start this "
                    "run in a fresh directory")
            return state
    if steps:
        warnings.warn(
            f"{len(steps)} checkpoint step(s) in {manager.root} exist but "
            "none restored against this run's RunState shapes — starting "
            "from iteration 0 (wrong t_outer / engine for this directory?)")
    return None


def _drive_chunks(state: RunState, program: Program, chunk_size: int,
                  manager: Optional[CheckpointManager],
                  max_chunks: Optional[int],
                  target_step: Optional[int] = None) -> RunState:
    """The outer chunk loop: run a chunk, checkpoint, repeat.

    Saves are async: the manager copies the state to the host on this
    thread and writes it on its own. ``max_chunks`` stops after that many
    chunks (a job killed at a chunk boundary); ``target_step`` stops at an
    absolute outer step, so re-running a crashed increment never advances
    the run twice.
    """
    t_outer = program.t_outer
    body = program.build_body(program.operands, **dict(program.statics))
    lanes = len(program.lane_shape)
    step = int(state.step)
    done = 0
    j = get_journal()
    step0, t_start = step, time.monotonic()
    while step < t_outer:
        if max_chunks is not None and done >= max_chunks:
            break
        if target_step is not None and step >= target_step:
            break
        length = min(chunk_size, t_outer - step)
        if target_step is not None:
            length = min(length, target_step - step)
        t0 = time.monotonic()
        state = _chunk(state, body, program.xs[..., step:step + length],
                       lanes, program.node_mask)
        step += length
        if j.enabled:
            j.event("chunk", "runtime", step=step, length=length,
                    dispatch_s=round(time.monotonic() - t0, 6))
        if manager is not None:
            manager.save(step, state, blocking=False)
        done += 1
    if manager is not None:
        manager.wait()
    if j.enabled and step > step0:
        wall = time.monotonic() - t_start    # incl. the final save barrier
        j.event("chunks_done", "runtime", steps=step - step0, chunks=done,
                wall_s=round(wall, 6),
                steps_per_s=round((step - step0) / wall, 3) if wall > 0
                else None)
    return state


def _run(program: Program, manager: Optional[CheckpointManager],
         chunk_size: int, max_chunks: Optional[int],
         target_step: Optional[int] = None):
    like = _init_state(program)
    restored = _restore_any(manager, like)
    # the step the run resumed from (a corrupt or stale newest checkpoint
    # falls back, so this can differ from manager.latest_step())
    program.restored_step = int(restored.step) if restored is not None else 0
    state = restored if restored is not None else like
    state = _drive_chunks(state, program, chunk_size, manager, max_chunks,
                          target_step)
    if program.finalize is None:
        return state
    return program.finalize(state, int(state.step))


def run_monolithic(program: Program):
    """The whole run as one chunk (the fused default path)."""
    return _run(program, None, max(program.t_outer, 1), None)


def run_chunked(program: Program, manager: Optional[CheckpointManager],
                chunk_size: int = 10, max_chunks: Optional[int] = None,
                target_step: Optional[int] = None):
    """The run ``chunk_size`` steps at a time, the ``RunState`` checkpointed
    through ``manager`` at every chunk boundary. A run restored from a kill
    at any boundary gives the same bits as the uninterrupted run;
    ``max_chunks`` simulates the kill, ``target_step`` stops at an absolute
    step."""
    return _run(program, manager, chunk_size, max_chunks, target_step)


def run_sweep(program: Program,
              manager: Optional[CheckpointManager] = None,
              chunk_size: Optional[int] = None,
              max_chunks: Optional[int] = None):
    """A case x seed sweep Program, by the same driver. Without ``manager``
    and ``chunk_size`` it is one chunk (the monolithic sweep); with them the
    sweep's RunState, lane axes on every buffer, is checkpointed at every
    chunk boundary, and a sweep killed there resumes mid-grid with the bits
    of the uninterrupted sweep."""
    if not (program.n_cases and program.n_seeds):
        raise ValueError("run_sweep needs a Program with case and seed axes"
                         " (use run_monolithic/run_chunked for single runs)")
    _check_case_axes(program)
    size = chunk_size if chunk_size is not None else max(program.t_outer, 1)
    return _run(program, manager, size, max_chunks)


def _check_case_axes(program: Program) -> None:
    """Every operand stacked by case leads with the case axis, and the
    schedule has one row a case."""
    axes = program.case_axes or (None,) * len(program.operands)
    if len(axes) != len(program.operands):
        raise ValueError(f"case_axes has {len(axes)} entries for "
                         f"{len(program.operands)} operands")
    for i, (op, ax) in enumerate(zip(program.operands, axes)):
        if ax is not None and op.shape[ax] != program.n_cases:
            raise ValueError(f"operand {i} is stacked by case on axis {ax} "
                             f"but has {op.shape[ax]} entries there for "
                             f"{program.n_cases} cases")
    if program.xs.shape[0] != program.n_cases or program.xs.ndim != 2:
        raise ValueError(f"a sweep's schedule is (C, T), got "
                         f"{program.xs.shape} for {program.n_cases} cases")


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def async_ledger(sched_np, sends, counts, payload_fn, slices) -> CommLedger:
    """Rebuild the realized async ledger from the RunState buffers.

    ``payload_fn(sends)`` prices the (T, *tail) float64 sends in payload
    elements; ``slices(t_c)`` lists the (index into a step's counts, live
    rounds) pairs of a step that ran ``t_c`` rounds, in gossip-call order.
    """
    ledger = CommLedger()
    sends_np = _host(sends).astype(np.float64)
    counts_np = _host(counts)
    total = float(sends_np.sum())
    ledger.p2p += total
    ledger.matrices += total
    ledger.scalars += payload_fn(sends_np)
    for t in range(len(sched_np)):
        for sl, rounds in slices(int(sched_np[t])):
            ledger.log_awake_rounds(counts_np[t][sl][:rounds])
    return ledger
