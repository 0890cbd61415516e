"""Shared checks and ctypes plumbing for the CUDA kernel wrappers."""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch


def check(t: torch.Tensor, name: str, dtypes: Sequence[torch.dtype],
          ndim: int, device: torch.device) -> None:
    """Raise ValueError unless ``t`` is a contiguous CUDA tensor of one of
    ``dtypes`` with ``ndim`` dims on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{list(dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed with CUDA error {err}")


# CUDA's limit on gridDim.y, the node / row axis of both kernels
MAX_GRID_Y = 65535
