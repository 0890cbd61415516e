"""Numerical linear algebra helpers: CholeskyQR2, random orthonormal init,
top-r eigenpairs.

CholeskyQR2 is the reference's QR everywhere: three matmuls and one tiny
(r x r) Cholesky per pass, two passes to restore the orthogonality lost to
squaring the condition number. Here every function takes a leading batch
of nodes as ordinary leading dims of the tensor. Each pass's Gram V^T V
goes through ``kernels/ops.gram_qr``: on the card one launch of the Hopper
Gram kernel for the whole batch, on the CPU the plain product.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops as kops

__all__ = ["cholesky_qr", "cholesky_qr2", "orthonormal_init", "eigh_topr"]


def cholesky_qr(v: torch.Tensor, eps: float = 0.0):
    """One CholeskyQR pass: V = Q R with Q^T Q ~= I. v: (..., d, r).

    The Gram is computed in float32 at minimum, as in the reference. On the
    card ``v`` must be f32 or bf16 (bf16 is promoted first): the Gram kernel
    has no f64 form, so a float64 ``v`` raises ValueError there. The CPU
    takes any floating dtype.
    """
    acc = torch.promote_types(v.dtype, torch.float32)
    va = v.to(acc)
    g = kops.gram_qr(va).to(acc)
    if eps:
        g = g + eps * torch.eye(g.shape[-1], dtype=acc, device=g.device)
    # cholesky_ex: like jnp.linalg.cholesky it does not raise on a Gram that
    # is not positive definite, and on CUDA it does not wait for the device
    # to check (torch.linalg.cholesky synchronises on every call)
    r = torch.linalg.cholesky_ex(g).L.mT  # upper triangular
    q = torch.linalg.solve_triangular(r, va, upper=True, left=False)
    return q.to(v.dtype), r.to(v.dtype)


def cholesky_qr2(v: torch.Tensor, eps: float = 1e-12):
    """CholeskyQR2: two passes; orthogonality error ~ machine eps."""
    q1, r1 = cholesky_qr(v, eps=eps)
    q2, r2 = cholesky_qr(q1, eps=0.0)
    return q2, r2 @ r1


def orthonormal_init(generator: torch.Generator, d: int, r: int, *,
                     dtype: torch.dtype = torch.float32,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """Random d x r matrix with orthonormal columns (Q_init of Alg. 1/2).

    Draws from ``generator`` on the generator's own device, then moves the
    result to ``device``. A torch stream differs from ``jax.random``'s, so
    parity tests pass the reference's ``q_init`` in instead.
    """
    a = torch.randn((d, r), generator=generator, dtype=torch.float32,
                    device=generator.device)
    q, _ = torch.linalg.qr(a)
    return q.to(device=device or q.device, dtype=dtype)


def eigh_topr(m: torch.Tensor, r: int):
    """Top-r eigenpairs of a symmetric matrix (ground truth for tests)."""
    vals, vecs = torch.linalg.eigh(m)
    return vals.flip(-1)[..., :r], vecs.flip(-1)[..., :r]
