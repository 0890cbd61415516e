"""CUDA wrapper for the Hopper flash-attention kernels
(``csrc/flash_attention.cu``).

Causal (optionally sliding-window) GQA attention with f32 online softmax,
one launch for all heads. Replaces ``flash_attention_pallas``
(``repro/kernels/flash_attention.py``). Call through
``ops.flash_attention``.

The dtype picks the kernel, and nothing else does: bf16 goes to the
tensor-core kernel (``tc_bf16``: wgmma, TMA, head dims padded to 64, 128
or 256), f32 to the CUDA-core kernel (``simt_f32``: exact f32). Each launch
adds one to its route's count in ``ROUTE_LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _launch
from .ref import kv_group

__all__ = ["flash_attention_cuda", "HEAD_DIMS", "ROUTE_LAUNCHES", "route",
           "padded_head_dim", "reset_route_launches", "tc_smem_bytes"]

HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the head dims the kernels take
TMA_ALIGN = 16                      # bytes: a TMA tensor map's base address
ROUTE_LAUNCHES: Dict[str, int] = {"tc_bf16": 0, "simt_f32": 0}


def reset_route_launches() -> None:
    for name in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[name] = 0


def route(dtype: torch.dtype) -> str:
    """The kernel that serves ``dtype``: bf16 on the tensor cores, f32 on
    the CUDA cores."""
    if dtype == torch.bfloat16:
        return "tc_bf16"
    if dtype == torch.float32:
        return "simt_f32"
    raise ValueError(f"flash-attention kernels take float32 or bfloat16, "
                     f"got {dtype}")


def padded_head_dim(hd: int) -> int:
    """The head dim the tensor-core kernel computes at: its tiles are built
    of 64-column boxes, and TMA fills the columns past ``hd`` with zeros."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash-attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def _lib():
    from . import _build
    lib = _build.load("flash_attention")
    if not getattr(lib, "_repro_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [vp] * 4 + [i] * 11 + [ctypes.c_float, i, vp, i, i])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_tc_smem_bytes.argtypes = [i]
        lib.flash_attention_tc_smem_bytes.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def tc_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one block of the tensor-core kernel at head
    dim ``hd``, in bytes (builds the library: CUDA only)."""
    return int(_lib().flash_attention_tc_smem_bytes(padded_head_dim(hd)))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int], scale: float,
                         q_offset: int, kv_valid: int,
                         group: Optional[int] = None,
                         q_head0: int = 0) -> torch.Tensor:
    """q: (b, hq, sq, hd), k/v: (b, hkv, skv, hd), all f32 or all bf16,
    contiguous on one CUDA device -> (b, hq, sq, hd). Query head i reads
    kv head (q_head0 + i) / group - q_head0 / group (``ref.expand_kv``;
    default group hq / hkv, hq % hkv == 0).

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
    if k.shape != (b, hkv, skv, hd) or v.shape != k.shape:
        raise ValueError(f"shapes do not align: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    group = kv_group(hq, hkv, group, q_head0)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash-attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if b * hq > _launch.MAX_GRID_Y:
        raise ValueError(f"flash-attention kernel takes at most "
                         f"{_launch.MAX_GRID_Y} (batch, head) pairs, got "
                         f"{b * hq}")
    path = route(q.dtype)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if skv == 0:
        return out.zero_()
    if path == "tc_bf16":
        # TMA reads from 16-byte-aligned bases; a view that starts elsewhere
        # is copied (a fresh allocation is aligned)
        q, k, v = (t if t.data_ptr() % TMA_ALIGN == 0 else t.clone()
                   for t in (q, k, v))
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            _launch.ptr(q), _launch.ptr(k), _launch.ptr(v), _launch.ptr(out),
            b, hq, hkv, sq, skv, hd, q_offset, kv_valid, int(causal),
            int(window is not None), 0 if window is None else window,
            float(scale), int(path == "tc_bf16"), _launch.stream(dev),
            group, q_head0)
    _launch.raise_on_error(err, "flash_attention_launch")
    ROUTE_LAUNCHES[path] += 1
    return out
