"""CUDA wrapper for the Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

Causal (optionally sliding-window) GQA attention with f32 online softmax,
one launch for all heads. Replaces ``flash_attention_pallas``
(``repro/kernels/flash_attention.py``). Call through
``ops.flash_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _launch

__all__ = ["flash_attention_cuda", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 80, 128)   # the head dims the kernel instantiates


def _lib():
    from . import _build
    lib = _build.load("flash_attention")
    if not getattr(lib, "_repro_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [vp] * 4 + [i] * 11 + [ctypes.c_float, i, vp])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int], scale: float,
                         q_offset: int, kv_valid: int) -> torch.Tensor:
    """q: (b, hq, sq, hd), k/v: (b, hkv, skv, hd), all f32 or all bf16,
    contiguous on one CUDA device, hq % hkv == 0 -> (b, hq, sq, hd).

    Query row i sits at position i + q_offset of the key stream; keys at or
    past ``kv_valid`` are masked.
    """
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _launch.check(t, name, (torch.float32, torch.bfloat16), 4, dev)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, skv, hd) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"shapes do not align: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash-attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if b * hq > _launch.MAX_GRID_Y:
        raise ValueError(f"flash-attention kernel takes at most "
                         f"{_launch.MAX_GRID_Y} (batch, head) pairs, got "
                         f"{b * hq}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if skv == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            _launch.ptr(q), _launch.ptr(k), _launch.ptr(v), _launch.ptr(out),
            b, hq, hkv, sq, skv, hd, q_offset, kv_valid, int(causal),
            int(window is not None), 0 if window is None else window,
            float(scale), int(q.dtype == torch.bfloat16), _launch.stream(dev))
    _launch.raise_on_error(err, "flash_attention_launch")
    return out
