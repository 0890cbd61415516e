"""Ragged node counts for the sweep engines: the twin of
``repro/core/sweep_utils.py``.

Cases with different node counts (ER N=10 beside ring N=20, the Table-II
connectivity axis) stack into one lane axis once every case is padded to
N_max with nodes that cannot perturb the real ones:

* **weights**: W becomes block-diag(W, I). A real node's gossip row has
  exact zeros against every padded column, so padded nodes never mix with
  real ones.
* **covariances** (sample-partitioned algorithms): padded nodes get
  *identity* covariances, not zeros: a zero cov would drive the padded
  iterate into the Cholesky of a singular Gram, and its NaNs would poison
  the padded lanes. A node mask keeps the padded estimates out of the
  error trace.
* **feature slabs** (feature-partitioned algorithms): padded nodes get
  all-zero slabs, which add nothing to any product of Alg. 2, so no mask
  is needed.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

__all__ = [
    "pad_weights_identity",
    "pad_covs_identity",
    "pad_zero_nodes",
    "case_node_masks",
    "broadcast_per_case",
]


def pad_weights_identity(w: np.ndarray, n_max: int) -> np.ndarray:
    """block-diag(W, I): the padded nodes are isolated self-loops."""
    out = np.eye(n_max)
    out[:w.shape[0], :w.shape[0]] = w
    return out


def pad_covs_identity(covs: torch.Tensor, n_max: int) -> torch.Tensor:
    """Pad a (N, d, d) cov stack to (N_max, d, d) with identity covs."""
    pad = n_max - covs.shape[0]
    if pad == 0:
        return covs
    d = covs.shape[1]
    eye = torch.eye(d, dtype=covs.dtype, device=covs.device)
    return torch.cat([covs, eye.expand(pad, d, d)], dim=0)


def pad_zero_nodes(stack: torch.Tensor, n_max: int) -> torch.Tensor:
    """Pad the leading node axis of a slab stack with all-zero entries."""
    pad = n_max - stack.shape[0]
    if pad == 0:
        return stack
    zeros = stack.new_zeros((pad,) + tuple(stack.shape[1:]))
    return torch.cat([stack, zeros], dim=0)


def case_node_masks(n_list: Sequence[int], n_max: int,
                    device=None) -> torch.Tensor:
    """(C, N_max) float mask: 1.0 for real nodes, 0.0 for padded ones."""
    mask = np.arange(n_max)[None, :] < np.asarray(list(n_list))[:, None]
    return torch.as_tensor(mask.astype(np.float32), device=device)


def broadcast_per_case(items, n_cases: int, what: str) -> List:
    """Zip-broadcast a per-case list against the case axis (1 -> n_cases)."""
    items = list(items)
    if len(items) == 1:
        items = items * n_cases
    if len(items) != n_cases:
        raise ValueError(f"per-case {what} must zip-broadcast with the "
                         f"cases: got {len(items)} for {n_cases} cases")
    return items
