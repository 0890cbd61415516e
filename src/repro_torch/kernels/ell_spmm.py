"""CUDA wrapper for the Hopper ELL gossip kernel (``csrc/ell_spmm.cu``).

out[i] = diag[i] z_own[i] + sum_l val[i, l] z_src[idx[i, l]], f32
accumulation, with an f32 or bf16 gather source. Replaces
``ell_spmm_pallas`` (``repro/kernels/ell_spmm.py``). Call through
``ops.ell_spmm``, which quantises the gather source for bf16 payloads.
"""
from __future__ import annotations

import ctypes

import torch

from . import _launch

__all__ = ["ell_spmm_cuda"]


def _lib():
    from . import _build
    lib = _build.load("ell_spmm")
    if not getattr(lib, "_repro_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ell_spmm_launch.argtypes = [vp] * 6 + [i] * 4 + [vp]
        lib.ell_spmm_launch.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def ell_spmm_cuda(ell_idx: torch.Tensor, ell_val: torch.Tensor,
                  diag: torch.Tensor, z_own: torch.Tensor,
                  z_src: torch.Tensor) -> torch.Tensor:
    """ell_idx: (N, L) int32, ell_val: (N, L) f32, diag: (N,) f32,
    z_own: (N, K) f32, z_src: (N_src, K) f32 or bf16, all contiguous on one
    CUDA device -> (N, K) f32.

    The indices are trusted to lie in [0, N_src): ``SparseW`` builds them
    from the graph, and checking them here would cost a device sync.
    """
    dev = z_own.device
    _launch.check(ell_idx, "ell_idx", (torch.int32,), 2, dev)
    _launch.check(ell_val, "ell_val", (torch.float32,), 2, dev)
    _launch.check(diag, "diag", (torch.float32,), 1, dev)
    _launch.check(z_own, "z_own", (torch.float32,), 2, dev)
    _launch.check(z_src, "z_src", (torch.float32, torch.bfloat16), 2, dev)
    n, k = z_own.shape
    width = ell_idx.shape[1]
    if (ell_idx.shape[0] != n or ell_val.shape != ell_idx.shape
            or diag.shape != (n,) or z_src.shape[1] != k):
        raise ValueError(f"shapes do not align: idx {tuple(ell_idx.shape)}, "
                         f"val {tuple(ell_val.shape)}, diag "
                         f"{tuple(diag.shape)}, z_own {tuple(z_own.shape)}, "
                         f"z_src {tuple(z_src.shape)}")
    if n > _launch.MAX_GRID_Y:
        raise ValueError(f"ELL kernel takes at most {_launch.MAX_GRID_Y} "
                         f"rows, got {n}")
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    if n == 0 or k == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.ell_spmm_launch(
            _launch.ptr(ell_idx), _launch.ptr(ell_val), _launch.ptr(diag),
            _launch.ptr(z_own), _launch.ptr(z_src), _launch.ptr(out), n, k,
            width, int(z_src.dtype == torch.bfloat16), _launch.stream(dev))
    _launch.raise_on_error(err, "ell_spmm_launch")
    return out
