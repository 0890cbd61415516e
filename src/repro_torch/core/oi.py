"""Centralized orthogonal iteration (the paper's reference algorithm)."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .linalg import cholesky_qr2

__all__ = ["orthogonal_iteration", "oi_trace"]


def orthogonal_iteration(m: torch.Tensor, q_init: torch.Tensor,
                         t_outer: int) -> torch.Tensor:
    """t_outer iterations of Q <- qr(M Q). Linear convergence at rate
    |lambda_{r+1}/lambda_r| (Golub & Van Loan)."""
    q = q_init
    for _ in range(t_outer):
        q = cholesky_qr2(m @ q)[0]
    return q


def oi_trace(m: torch.Tensor, q_init: torch.Tensor, t_outer: int,
             metric: Optional[Callable] = None):
    """Like orthogonal_iteration but returns (q, the per-iteration metric
    trace): ``metric(q)`` after each iteration, stacked (zeros without a
    metric)."""
    q, trace = q_init, []
    for _ in range(t_outer):
        q = cholesky_qr2(m @ q)[0]
        trace.append(torch.as_tensor(metric(q), device=q.device)
                     if metric is not None
                     else torch.zeros((), dtype=q.dtype, device=q.device))
    if not trace:
        return q, torch.zeros((0,), dtype=q.dtype, device=q.device)
    return q, torch.stack(trace)
