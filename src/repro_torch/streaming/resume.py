"""Chunked, restartable fused runs: the twin of ``repro/streaming/resume.py``.

Each entry point registers its family's ``Program`` and hands it to
``runtime.run_chunked``:

    <family>_program (core/sdot | fdot | bdot | baselines)
      -> runtime.run_chunked(program, manager, chunk_size)
         - restore the newest valid RunState (or start fresh)
         - per chunk: ``chunk_size`` steps of the same outer-iteration
           body as the monolithic run, the chunk's errors written into the
           trace buffer in place
         - checkpoint (atomic, async) at every chunk boundary
      -> the family's finalize() builds the usual result

**Resume invariant** (pinned in tests/test_torch_runtime.py and on the card
by chip_smoke.py's ``resume`` phase): a run killed at any chunk boundary,
restored and continued gives the bit-identical error trace, iterate and
ledger of the uninterrupted run. Three things make it exact: a chunk runs
the same kernels on the same inputs as the monolithic loop (every kernel
of the port sums in a fixed order, with no atomics); a step's singular
values do not depend on which steps share its chunk's batched SVD call
(cuSOLVER's result for a matrix does not depend on its batch, which
chip_smoke.py checks), and its mean over the nodes is its own reduction;
and the ledger is priced in closed form from the completed step count. A corrupt or half-written
newest checkpoint is skipped for the newest one that restores.

A checkpoint directory holds one run: callers own its hygiene. The port and
the reference write the same layout, so a sync run the reference
checkpointed can be finished here (``tests/test_torch_runtime.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .._device import DeviceLike
from ..checkpoint.manager import CheckpointManager
from ..core.baselines import BaselineResult, baseline_program
from ..core.bdot import BDOTResult, bdot_program
from ..core.consensus import DenseConsensus
from ..core.fdot import FDOTResult, fdot_program
from ..core.runtime import RunState, run_chunked
from ..core.sdot import SDOTResult, sdot_program

__all__ = ["RunState", "sdot_chunked", "fdot_chunked", "bdot_chunked",
           "baseline_chunked"]


def sdot_chunked(
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
    chunk_size: int = 10,
    manager: Optional[CheckpointManager] = None,
    max_chunks: Optional[int] = None,
) -> SDOTResult:
    """Chunked, restartable S-DOT/SA-DOT: ``sdot(fused=True)``'s bits, run
    ``chunk_size`` outer iterations at a time with the ``RunState``
    checkpointed through ``manager`` at every boundary. A ``manager`` that
    already holds a snapshot of this run resumes from it; ``max_chunks``
    stops after that many chunks (a killed job), and the result then covers
    the completed prefix."""
    return run_chunked(
        sdot_program(covs=covs, data=data, engine=engine, r=r,
                     t_outer=t_outer, schedule=schedule, t_c=t_c,
                     q_init=q_init, q_true=q_true, generator=generator,
                     device=device),
        manager, chunk_size=chunk_size, max_chunks=max_chunks)


def fdot_chunked(
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
    chunk_size: int = 10,
    manager: Optional[CheckpointManager] = None,
    max_chunks: Optional[int] = None,
) -> FDOTResult:
    """Chunked, restartable F-DOT: ``fdot(fused=True)``'s bits, with the
    resume contract of ``sdot_chunked``."""
    return run_chunked(
        fdot_program(data_blocks=data_blocks, engine=engine, r=r,
                     t_outer=t_outer, t_c=t_c, t_c_qr=t_c_qr,
                     schedule=schedule, q_init=q_init, q_true=q_true,
                     generator=generator, device=device),
        manager, chunk_size=chunk_size, max_chunks=max_chunks)


def bdot_chunked(
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
    chunk_size: int = 10,
    manager: Optional[CheckpointManager] = None,
    max_chunks: Optional[int] = None,
) -> BDOTResult:
    """Chunked, restartable B-DOT: ``bdot(fused=True)``'s bits, with the
    resume contract of ``sdot_chunked``."""
    return run_chunked(
        bdot_program(blocks=blocks, col_engines=col_engines,
                     row_engines=row_engines, r=r, t_outer=t_outer, t_c=t_c,
                     t_c_qr=t_c_qr, schedule=schedule, q_init=q_init,
                     q_true=q_true, generator=generator, device=device),
        manager, chunk_size=chunk_size, max_chunks=max_chunks)


def baseline_chunked(
    name: str,
    *,
    covs: Optional[torch.Tensor] = None,
    data_blocks: Optional[Sequence[torch.Tensor]] = None,
    engine: DenseConsensus,
    r: int,
    t_outer: Optional[int] = None,
    iters_per_vec: Optional[int] = None,
    lr: float = 0.1,
    t_mix: int = 3,
    t_c: int = 50,
    q_true: Optional[torch.Tensor] = None,
    seed: int = 0,
    q_init: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    chunk_size: int = 10,
    manager: Optional[CheckpointManager] = None,
    max_chunks: Optional[int] = None,
) -> BaselineResult:
    """Chunked, restartable fused baseline (any of the five distributed
    ones), with the resume contract of ``sdot_chunked``.

    ``name``: dsa | dpgd | deepca | seq_dist_pm | d_pm, with the problem
    arguments of ``core.baselines.baseline_program``. The
    sequential-deflation methods chunk over the flattened (vector, inner
    iteration) index, so a kill mid-deflation resumes where the
    Gram-Schmidt order left off; DeEPCA's (q, s, mq_prev) tracking triple
    is its carry. The ledger covers the completed prefix."""
    return run_chunked(
        baseline_program(name, covs=covs, data_blocks=data_blocks,
                         engine=engine, r=r, t_outer=t_outer,
                         iters_per_vec=iters_per_vec, lr=lr, t_mix=t_mix,
                         t_c=t_c, q_true=q_true, seed=seed, q_init=q_init,
                         generator=generator, device=device),
        manager, chunk_size=chunk_size, max_chunks=max_chunks)
