"""Centralized orthogonal iteration (the paper's reference algorithm)."""
from __future__ import annotations

import torch

from .linalg import cholesky_qr2

__all__ = ["orthogonal_iteration"]


def orthogonal_iteration(m: torch.Tensor, q_init: torch.Tensor,
                         t_outer: int) -> torch.Tensor:
    """t_outer iterations of Q <- qr(M Q). Linear convergence at rate
    |lambda_{r+1}/lambda_r| (Golub & Van Loan)."""
    q = q_init
    for _ in range(t_outer):
        q = cholesky_qr2(m @ q)[0]
    return q
