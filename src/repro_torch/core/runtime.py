"""Unified executor runtime: one Program protocol, generic drivers.

The twin of ``repro/core/runtime.py``. Every fused family (S-DOT/SA-DOT,
F-DOT, B-DOT) registers its run as a ``Program``, and the drivers execute
any Program:

* ``run_monolithic``: the whole run as one chunk, the fused default path
  of ``sdot`` / ``fdot`` / ``bdot``;
* ``run_chunked``: ``chunk_size`` outer iterations at a time, with the
  ``RunState`` checkpointed through a ``CheckpointManager`` at every chunk
  boundary; a run killed at any boundary and resumed gives the same bits
  as the uninterrupted run (the trace, the iterate and the ledger).

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
  rounds, as the reference's masked scan does.

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
    refused.
    """

    q: Any                    # the family's carry (iterate, slabs, ...)
    key: torch.Tensor         # host: () uint32 zeros, or (2,) int64 key
    step: torch.Tensor        # () int32 on the host: outer steps completed
    errs: torch.Tensor        # (T_o,) f32 error trace
    sends: torch.Tensor       # (T_o, *tail) f32 per-round sends
    counts: torch.Tensor      # (T_o, *tail) f32 per-round awake counts


_tree.register_node(
    RunState,
    lambda s: ((s.q, s.key, s.step, s.errs, s.sends, s.counts), None),
    lambda _aux, children: RunState(*children))


@dataclasses.dataclass
class Program:
    """One family's run, in the form every driver understands.

    Families build these with ``core/sdot.sdot_program``,
    ``core/fdot.fdot_program`` and ``core/bdot.bdot_program``, from the same
    prepared inputs as their eager oracles.
    """

    build_body: Callable      # module-level: (operands, **statics) -> body
    operands: Tuple           # tensors the body closes over
    statics: Tuple            # ((name, value), ...) for build_body
    xs: np.ndarray            # (T_o,) host-side schedule
    q0: Any                   # initial carry
    key0: Optional[torch.Tensor] = None   # async key; None: a sync run
    tail: Tuple[int, ...] = ()            # per-step sends/counts shape
    finalize: Optional[Callable] = None   # (state, done) -> family result
    restored_step: int = 0    # set by the driver: the step restored from
                              # the manager (0 = fresh start)

    @property
    def t_outer(self) -> int:
        return int(self.xs.shape[-1])


def step_errors(crosses: List[torch.Tensor]) -> torch.Tensor:
    """Each step's error: eq. (11) of its cross products, averaged over
    them (over the nodes for S-DOT; F-DOT/B-DOT have one). One SVD call for
    the chunk; the node mean adds the nodes' columns one at a time, element
    by element, so a step's sum is the same whatever else shares its chunk
    and the chunk costs N launches, not one a step."""
    errs = subspace_error_from_cross(torch.stack(crosses))  # (L,) | (L, N)
    if errs.dim() == 1:
        return errs
    total = errs[:, 0]
    for k in range(1, errs.shape[1]):
        total = total + errs[:, k]
    return total / errs.shape[1]


def _chunk(state: RunState, body: Callable, xs: np.ndarray) -> RunState:
    """Advance ``state`` by ``len(xs)`` steps of ``body``."""
    carry, key = state.q, state.key
    crosses, sends, counts = [], [], []
    for x in xs:
        (carry, key), (cross, s, c) = body((carry, key), int(x))
        if cross is not None:
            crosses.append(cross)
        if s is not None:
            sends.append(s)
            counts.append(c)
    begin = int(state.step)
    end = begin + len(xs)
    if crosses:
        state.errs[begin:end] = step_errors(crosses).to(state.errs.device)
    if sends:
        state.sends[begin:end] = torch.stack(sends)
        state.counts[begin:end] = torch.stack(counts)
    return dataclasses.replace(state, q=carry, key=key,
                               step=torch.tensor(end, dtype=torch.int32))


def _init_state(program: Program) -> RunState:
    dev = _tree.tree_leaves(program.q0)[0].device
    shape = (program.t_outer,) + tuple(program.tail)
    return RunState(
        q=program.q0,
        key=(torch.zeros((), dtype=torch.uint32) if program.key0 is None
             else program.key0.clone()),
        step=torch.zeros((), dtype=torch.int32),
        errs=torch.zeros((program.t_outer,), dtype=torch.float32,
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
        state = _chunk(state, body, program.xs[step:step + length])
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


def run_sweep(*args, **kwargs):
    raise NotImplementedError(
        "case x seed sweeps come with the sweep slice of the port (ROADMAP "
        "queue 1, item 12)")


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
