"""CUDA wrapper for the Hopper Gram kernel of CholeskyQR (``csrc/gram_qr.cu``).

G[b] = V_b^T V_b for a batch of tall-skinny matrices, f32 or bf16 in, f32
out, exactly symmetric. Replaces ``gram_qr_pallas``
(``repro/kernels/gram_qr.py``). Call through ``ops.gram_qr``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from . import _launch

__all__ = ["gram_qr_cuda"]

# At or below this many rows one block walks a matrix's rows in order: a
# second pass would cost more than the walk.
_SINGLE_PASS_ROWS = 2048
_MIN_RANGE_ROWS = 256           # rows a range of a split matrix holds at least


@functools.cache
def _lib():
    from . import _build
    lib = _build.load("gram_qr")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.gram_qr_launch.argtypes = [vp, i, vp, vp] + [i] * 5 + [vp]
    lib.gram_qr_launch.restype = ctypes.c_int
    lib.gram_qr_tile_pairs.argtypes = [i]
    lib.gram_qr_tile_pairs.restype = ctypes.c_int
    lib.gram_qr_blocks_per_sm.argtypes = [i, i]
    lib.gram_qr_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _plan(device_index: int, batch: int, d: int, r: int, is_bf16: bool):
    """(rows_per_range, ranges) for these shapes on this card, cached so a
    launch makes no extra call into the library.

    A tall matrix is cut into as many fixed row ranges as one wave of
    resident blocks holds, each of at least ``_MIN_RANGE_ROWS`` rows.
    """
    lib = _lib()
    if lib.gram_qr_tile_pairs(r) > _launch.MAX_GRID_Y:
        raise ValueError(f"gram_qr kernel: r={r} has too many output tiles")
    if d <= _SINGLE_PASS_ROWS:
        return d, 1
    per_sm = lib.gram_qr_blocks_per_sm(r, int(is_bf16))
    if per_sm <= 0:
        raise RuntimeError(f"gram_qr: no block for r={r} fits on an SM")
    props = torch.cuda.get_device_properties(device_index)
    slots = per_sm * props.multi_processor_count
    blocks = batch * lib.gram_qr_tile_pairs(r)
    ranges = max(1, min(math.ceil(d / _MIN_RANGE_ROWS), slots // blocks))
    rows = math.ceil(d / ranges)
    return rows, math.ceil(d / rows)


def gram_qr_cuda(v: torch.Tensor) -> torch.Tensor:
    """v: (B, d, r) f32 or bf16, contiguous on a CUDA device -> (B, r, r)
    f32."""
    dev = v.device
    _launch.check(v, "v", (torch.float32, torch.bfloat16), 3, dev)
    batch, d, r = v.shape
    if not 1 <= batch <= _launch.MAX_GRID_Y:
        raise ValueError(f"gram_qr kernel takes 1..{_launch.MAX_GRID_Y} "
                         f"matrices, got {batch}")
    g = torch.empty((batch, r, r), dtype=torch.float32, device=dev)
    if r == 0:
        return g
    if d == 0:
        return g.zero_()
    is_bf16 = v.dtype == torch.bfloat16
    current = torch.cuda.current_device()
    index = dev.index if dev.index is not None else current
    rows, ranges = _plan(index, batch, d, r, is_bf16)
    partial = (torch.empty((batch, ranges, r, r), dtype=torch.float32,
                           device=dev) if ranges > 1 else g)
    # the launch goes to the current device: switch only when v is elsewhere
    with (torch.cuda.device(index) if index != current
          else contextlib.nullcontext()):
        err = _lib().gram_qr_launch(_launch.ptr(v), int(is_bf16),
                                    _launch.ptr(partial), _launch.ptr(g),
                                    batch, d, r, rows, ranges,
                                    _launch.stream(dev))
    _launch.raise_on_error(err, "gram_qr_launch")
    return g
