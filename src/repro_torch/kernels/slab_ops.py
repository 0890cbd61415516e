"""CUDA wrappers for the Hopper slab and grid kernels (``csrc/slab_ops.cu``).

Two kernels over a stack of B = I * J blocks of X, each (d, n):

* ``slab_tq_cuda``: Z[b] = X_b^T Q[b // J], one launch. Replaces
  ``batched_slab_tq_pallas`` ((I, J) = (N, 1)) and ``grid_block_tq_pallas``
  (``repro/kernels/slab_ops.py``).
* ``slab_apply_cuda``: V[b] = X_b S[b % J], a launch pair: pass 1 writes one
  (d, r) partial per (block, range of the sample axis), pass 2 sums them in a
  fixed order. Replaces ``batched_slab_apply_pallas`` ((I, J) = (1, N)) and
  ``grid_block_apply_pallas``.

Call through ``ops.batched_slab_tq`` / ``batched_slab_apply`` /
``grid_block_tq`` / ``grid_block_apply``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _launch

__all__ = ["slab_tq_cuda", "slab_apply_cuda", "MAX_R"]

MAX_R = 64                      # largest r the kernels instantiate


def _lib():
    from . import _build
    lib = _build.load("slab_ops")
    if not getattr(lib, "_repro_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.slab_tq_launch.argtypes = [vp] * 3 + [i] * 5 + [vp]
        lib.slab_tq_launch.restype = i
        lib.slab_apply_launch.argtypes = [vp] * 4 + [i] * 7 + [vp]
        lib.slab_apply_launch.restype = i
        lib.slab_apply_row_chunks.argtypes = [i, i]
        lib.slab_apply_row_chunks.restype = i
        lib.slab_apply_chunk.argtypes = []
        lib.slab_apply_chunk.restype = i
        lib.slab_apply_blocks_per_sm.argtypes = [i]
        lib.slab_apply_blocks_per_sm.restype = i
        lib._repro_typed = True
    return lib


@functools.lru_cache(maxsize=64)
def _apply_plan(device_index: int, blocks: int, d: int, n: int, r: int):
    """(splits, cols_per_split) for these shapes on this card.

    The sample axis is split so that all (range, row chunk, block) blocks of
    pass 1 run in one wave of the resident blocks the card holds.
    """
    lib = _lib()
    per_sm = lib.slab_apply_blocks_per_sm(r)
    if per_sm <= 0:
        raise RuntimeError(f"slab-apply: no block for r={r} fits on an SM")
    props = torch.cuda.get_device_properties(device_index)
    slots = per_sm * props.multi_processor_count
    chunk = lib.slab_apply_chunk()
    work = blocks * lib.slab_apply_row_chunks(d, r)
    chunks = math.ceil(n / chunk)
    splits = min(chunks, max(1, slots // work))
    cols_per_split = math.ceil(chunks / splits) * chunk
    return math.ceil(n / cols_per_split), cols_per_split


def _check_r(r: int, what: str) -> None:
    if not 1 <= r <= MAX_R:
        raise ValueError(f"{what} kernel takes 1 <= r <= {MAX_R}, got {r}")


def slab_tq_cuda(x: torch.Tensor, q: torch.Tensor,
                 j_cols: int) -> torch.Tensor:
    """x: (B, d, n) f32, q: (B // j_cols, d, r) f32, both contiguous on one
    CUDA device -> Z: (B, n, r) f32 with Z[b] = x[b]^T q[b // j_cols]."""
    dev = x.device
    _launch.check(x, "x", (torch.float32,), 3, dev)
    _launch.check(q, "q", (torch.float32,), 3, dev)
    blocks, d, n = x.shape
    r = q.shape[2]
    if j_cols < 1 or blocks % j_cols or q.shape[:2] != (blocks // j_cols, d):
        raise ValueError(f"shapes do not align: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, {j_cols} grid columns")
    _check_r(r, "slab-tq")
    if not 1 <= blocks <= _launch.MAX_GRID_Y:
        raise ValueError(f"slab-tq kernel takes 1..{_launch.MAX_GRID_Y} "
                         f"blocks, got {blocks}")
    z = torch.empty((blocks, n, r), dtype=torch.float32, device=dev)
    if n == 0:
        return z
    if d == 0:
        return z.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.slab_tq_launch(_launch.ptr(x), _launch.ptr(q),
                                 _launch.ptr(z), blocks, j_cols, d, n, r,
                                 _launch.stream(dev))
    _launch.raise_on_error(err, "slab_tq_launch")
    return z


def slab_apply_cuda(x: torch.Tensor, s: torch.Tensor,
                    j_cols: int) -> torch.Tensor:
    """x: (B, d, n) f32, s: (j_cols, n, r) f32 with j_cols dividing B, both
    contiguous on one CUDA device -> V: (B, d, r) f32 with
    V[b] = x[b] s[b % j_cols]."""
    dev = x.device
    _launch.check(x, "x", (torch.float32,), 3, dev)
    _launch.check(s, "s", (torch.float32,), 3, dev)
    blocks, d, n = x.shape
    r = s.shape[2]
    if j_cols < 1 or blocks % j_cols or s.shape[:2] != (j_cols, n):
        raise ValueError(f"shapes do not align: x {tuple(x.shape)}, s "
                         f"{tuple(s.shape)}")
    _check_r(r, "slab-apply")
    if not 1 <= blocks <= _launch.MAX_GRID_Y:
        raise ValueError(f"slab-apply kernel takes 1..{_launch.MAX_GRID_Y} "
                         f"blocks, got {blocks}")
    v = torch.empty((blocks, d, r), dtype=torch.float32, device=dev)
    if d == 0:
        return v
    if n == 0:
        return v.zero_()
    lib = _lib()
    splits, cols = _apply_plan(dev.index if dev.index is not None
                               else torch.cuda.current_device(),
                               blocks, d, n, r)
    partial = torch.empty((blocks, splits, d, r), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        err = lib.slab_apply_launch(
            _launch.ptr(x), _launch.ptr(s), _launch.ptr(partial),
            _launch.ptr(v), blocks, j_cols, d, n, r, cols, splits,
            _launch.stream(dev))
    _launch.raise_on_error(err, "slab_apply_launch")
    return v
