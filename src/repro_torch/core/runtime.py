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
  returning one outer step ``body(carry, t_c) -> (carry', cross)``.
  ``carry`` is the family's iterate (an (N, d, r) stack for S-DOT, padded
  slabs for F-DOT/B-DOT). ``cross`` is the step's Q_true^T Q cross
  products (..., r, r), or None without a ground truth. Only synchronous
  engines run here; the asynchronous RNG key and per-round sends/counts
  come with the straggler slice (ROADMAP queue 1, item 8).
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
from .metrics import subspace_error_from_cross

__all__ = ["RunState", "Program", "run_monolithic", "run_chunked",
           "run_sweep", "async_ledger"]


@dataclasses.dataclass
class RunState:
    """Everything a run needs to continue from a chunk boundary.

    The leaves keep the reference's order and names (``0`` ... ``5`` in a
    checkpoint), so the port restores a step the reference wrote for a sync
    run and the reverse. ``key``, ``sends`` and ``counts`` hold the zeros
    the reference writes for a sync run; nothing here changes them.
    """

    q: Any                    # the family's carry (iterate, slabs, ...)
    key: torch.Tensor         # () uint32 zeros on the host (async RNG slot)
    step: torch.Tensor        # () int32 on the host: outer steps completed
    errs: torch.Tensor        # (T_o,) f32 error trace
    sends: torch.Tensor       # (T_o,) f32 zeros (async per-round sends)
    counts: torch.Tensor      # (T_o,) f32 zeros (async awake counts)


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
    finalize: Optional[Callable] = None   # (state, done) -> family result
    restored_step: int = 0    # set by the driver: the step restored from
                              # the manager (0 = fresh start)

    @property
    def t_outer(self) -> int:
        return int(self.xs.shape[-1])


def _step_errors(crosses: List[torch.Tensor]) -> torch.Tensor:
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
    carry = state.q
    crosses = []
    for x in xs:
        carry, cross = body(carry, int(x))
        if cross is not None:
            crosses.append(cross)
    begin = int(state.step)
    end = begin + len(xs)
    if crosses:
        state.errs[begin:end] = _step_errors(crosses).to(state.errs.device)
    return dataclasses.replace(state, q=carry,
                               step=torch.tensor(end, dtype=torch.int32))


def _init_state(program: Program) -> RunState:
    dev = _tree.tree_leaves(program.q0)[0].device
    t_outer = program.t_outer
    return RunState(
        q=program.q0, key=torch.zeros((), dtype=torch.uint32),
        step=torch.zeros((), dtype=torch.int32),
        errs=torch.zeros((t_outer,), dtype=torch.float32, device=dev),
        sends=torch.zeros((t_outer,), dtype=torch.float32, device=dev),
        counts=torch.zeros((t_outer,), dtype=torch.float32, device=dev))


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


def async_ledger(*args, **kwargs):
    raise NotImplementedError(
        "the realized ledger of asynchronous gossip comes with the "
        "straggler/fault-gossip slice of the port (ROADMAP queue 1, item 8)")
