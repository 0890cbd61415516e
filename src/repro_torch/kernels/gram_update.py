"""CUDA wrapper for the Hopper gram-apply kernel (``csrc/gram_update.cu``).

V[i] = X_i (X_i^T Q_i) / n_i for all nodes in one launch pair: pass 1 writes
one (d, r) partial per (node, column range), pass 2 sums them in a fixed
order and divides by n_true. Replaces ``batched_gram_apply_pallas`` and, as
its N = 1 launch, ``gram_apply_pallas`` (``repro/kernels/gram_update.py``).
Call through ``ops.batched_gram_apply`` / ``ops.gram_apply``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _launch

__all__ = ["batched_gram_apply_cuda", "MAX_R"]

MAX_R = 64                      # largest r the kernel instantiates
_BLOCK_COLS = (16, 8, 4, 2, 1)  # column-tile widths, widest that fits first
_SMEM_OPTIN = 232_448           # H100: dynamic shared memory a block can use


def _lib():
    from . import _build
    lib = _build.load("gram_update")
    if not getattr(lib, "_repro_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gram_apply_launch.argtypes = [vp] * 5 + [i] * 7 + [vp]
        lib.gram_apply_launch.restype = ctypes.c_int
        lib.gram_apply_smem_bytes.argtypes = [i, i, i]
        lib.gram_apply_smem_bytes.restype = ctypes.c_size_t
        lib.gram_apply_blocks_per_sm.argtypes = [i, i, i]
        lib.gram_apply_blocks_per_sm.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


@functools.lru_cache(maxsize=64)
def _plan(device_index: int, nodes: int, d: int, n: int, r: int):
    """(bn, splits, cols_per_split) for these shapes on this card.

    The column axis is split so that all (node, range) blocks run in one wave
    of the resident blocks the card holds: a second, nearly empty wave
    would double the time.
    """
    lib = _lib()
    props = torch.cuda.get_device_properties(device_index)
    limit = getattr(props, "shared_memory_per_block_optin", _SMEM_OPTIN)
    fits = [bn for bn in _BLOCK_COLS
            if lib.gram_apply_smem_bytes(d, r, bn) <= limit]
    if not fits:
        raise ValueError(f"gram-apply: d={d}, r={r} needs more shared memory "
                         f"than a block has ({limit} bytes)")
    occupancy = {bn: lib.gram_apply_blocks_per_sm(d, r, bn) for bn in fits}
    # the widest tile that still lets two blocks share an SM (one block's
    # loads overlap the other's arithmetic), else the widest that fits
    bn = next((b for b in fits if occupancy[b] >= 2), fits[0])
    per_sm = occupancy[bn]
    if per_sm <= 0:
        raise RuntimeError(f"gram-apply: no block of (d={d}, r={r}, "
                           f"bn={bn}) fits on an SM")
    slots = per_sm * props.multi_processor_count
    tiles = max(1, math.ceil(n / bn))
    splits = min(tiles, max(1, slots // nodes))
    cols_per_split = math.ceil(tiles / splits) * bn
    return bn, max(1, math.ceil(n / cols_per_split)), cols_per_split


def batched_gram_apply_cuda(x_stack: torch.Tensor, q_stack: torch.Tensor,
                            n_true: torch.Tensor) -> torch.Tensor:
    """x_stack: (N, d, n) f32, q_stack: (N, d, r) f32, n_true: (N,) f32,
    all contiguous on one CUDA device -> (N, d, r) f32.

    Columns of node i past ceil(n_true[i]) are padding and are not read.
    """
    dev = x_stack.device
    _launch.check(x_stack, "x_stack", (torch.float32,), 3, dev)
    _launch.check(q_stack, "q_stack", (torch.float32,), 3, dev)
    _launch.check(n_true, "n_true", (torch.float32,), 1, dev)
    nodes, d, n = x_stack.shape
    if q_stack.shape[:2] != (nodes, d) or n_true.shape != (nodes,):
        raise ValueError(f"shapes do not align: x {tuple(x_stack.shape)}, "
                         f"q {tuple(q_stack.shape)}, n_true "
                         f"{tuple(n_true.shape)}")
    r = q_stack.shape[2]
    if not 1 <= r <= MAX_R:
        raise ValueError(f"gram-apply kernel takes 1 <= r <= {MAX_R}, got {r}")
    if not 1 <= nodes <= _launch.MAX_GRID_Y:
        raise ValueError(f"gram-apply kernel takes 1..{_launch.MAX_GRID_Y} "
                         f"nodes, got {nodes}")
    v = torch.empty((nodes, d, r), dtype=torch.float32, device=dev)
    if d == 0 or n == 0:
        return v.zero_()
    lib = _lib()
    bn, splits, cols = _plan(dev.index if dev.index is not None
                             else torch.cuda.current_device(), nodes, d, n, r)
    partial = torch.empty((nodes, splits, d, r), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        err = lib.gram_apply_launch(
            _launch.ptr(x_stack), _launch.ptr(q_stack), _launch.ptr(n_true),
            _launch.ptr(partial), _launch.ptr(v), nodes, d, n, r, bn, cols,
            splits, _launch.stream(dev))
    _launch.raise_on_error(err, "gram_apply_launch")
    return v
