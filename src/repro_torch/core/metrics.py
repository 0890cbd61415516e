"""Subspace error metrics and communication-cost accounting.

The error metric is the paper's eq. (11): the mean squared sine of the
principal angles between the estimated and true subspaces. The ledger holds
plain Python floats, so two ledgers compare exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _tree

__all__ = [
    "subspace_error",
    "subspace_error_from_cross",
    "mean_subspace_error",
    "projector_distance",
    "principal_angles",
    "CommLedger",
    "p2p_per_consensus_round",
]


def subspace_error_from_cross(cross: torch.Tensor) -> torch.Tensor:
    """Eq. (11) from a cross product ``Q_true^T Q_hat``: (..., r, r') -> (...)."""
    s = torch.linalg.svdvals(cross)
    r = cross.shape[-2]
    return (1.0 - s[..., :r].clamp(0.0, 1.0) ** 2).mean(dim=-1)


def subspace_error(q_true: torch.Tensor, q_hat: torch.Tensor) -> torch.Tensor:
    """Paper eq. (11): E = (1/r) sum_i (1 - sigma_i^2(Q^T Qhat)).

    ``q_hat`` may carry leading batch dims: (..., d, r) -> (...).
    Invariant to right-rotation of either argument.
    """
    return subspace_error_from_cross(q_true.mT @ q_hat)


def mean_subspace_error(q_true: torch.Tensor, q_nodes: torch.Tensor,
                        node_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Mean of eq. (11) over stacked per-node estimates q_nodes: (N, d, r).

    ``node_mask`` (N,) restricts the mean to mask > 0 nodes.
    """
    errs = subspace_error(q_true, q_nodes)
    if node_mask is None:
        return errs.mean()
    m = node_mask.to(errs.dtype)
    return (errs * m).sum() / m.sum()


def projector_distance(q_true: torch.Tensor,
                       q_hat: torch.Tensor) -> torch.Tensor:
    """||QQ^T - Qhat Qhat^T||_2 — the quantity bounded by Theorem 1."""
    p1 = q_true @ q_true.T
    p2 = q_hat @ q_hat.T
    return torch.linalg.matrix_norm(p1 - p2, ord=2)


def principal_angles(q_true: torch.Tensor,
                     q_hat: torch.Tensor) -> torch.Tensor:
    """The principal angles between span(q_true) and span(q_hat), (r,)."""
    s = torch.linalg.svdvals(q_true.T @ q_hat)
    return torch.arccos(s.clamp(-1.0, 1.0))


def p2p_per_consensus_round(adjacency: np.ndarray) -> float:
    """Average point-to-point sends per node per consensus round."""
    n = adjacency.shape[0]
    return float(adjacency.sum() / n)


@dataclasses.dataclass
class CommLedger:
    """Accumulates communication events for an algorithm run.

    p2p          : point-to-point messages, total over nodes
    matrices     : number of d-x-r matrix sends (the paper's 'unit' cost)
    scalars      : payload element count actually moved
    awake_counts : per-round awake-node counts logged by async and faulty
                   engines (empty for synchronous runs)
    payload_bytes: ``scalars`` priced at the engine's payload element width
                   (4 for f32 gossip, 2 for bf16 payloads)
    """

    p2p: float = 0.0
    matrices: float = 0.0
    scalars: float = 0.0
    awake_counts: list = dataclasses.field(default_factory=list)
    payload_bytes: float = 0.0

    def log_awake_rounds(self, counts) -> None:
        """Record realized per-round awake-node counts (async gossip)."""
        if isinstance(counts, torch.Tensor):
            counts = counts.cpu().numpy()
        self.awake_counts.extend(int(c) for c in np.asarray(counts).ravel())

    def mean_awake(self) -> float:
        """Mean awake nodes per round over the logged async rounds."""
        return (float(np.mean(self.awake_counts)) if self.awake_counts
                else float("nan"))

    def log_gossip_round(self, adjacency: np.ndarray, payload_elems: int,
                         bytes_per_elem: float = 4.0) -> None:
        sends = float(adjacency.sum())  # directed messages this round
        self.p2p += sends
        self.matrices += sends
        self.scalars += sends * payload_elems
        self.payload_bytes += sends * payload_elems * bytes_per_elem

    def log_gossip_rounds(self, schedule, adjacency: np.ndarray,
                          payload_elems: int,
                          bytes_per_elem: float = 4.0) -> None:
        """Closed-form accounting for a whole run's consensus schedule
        (equal to one ``log_gossip_round`` per round, in O(1))."""
        rounds = float(np.asarray(schedule, dtype=np.float64).sum())
        sends = float(adjacency.sum()) * rounds
        self.p2p += sends
        self.matrices += sends
        self.scalars += sends * payload_elems
        self.payload_bytes += sends * payload_elems * bytes_per_elem

    def per_node_p2p(self, n_nodes: int) -> float:
        return self.p2p / n_nodes

    def merged(self, other: "CommLedger") -> "CommLedger":
        return CommLedger(
            self.p2p + other.p2p,
            self.matrices + other.matrices,
            self.scalars + other.scalars,
            self.awake_counts + other.awake_counts,
            self.payload_bytes + other.payload_bytes,
        )

    def merge_from(self, other: "CommLedger") -> None:
        """Accumulate ``other`` in place (a caller's running ledger takes a
        finished run's accounting, e.g. a fused baseline's closed form)."""
        self.p2p += other.p2p
        self.matrices += other.matrices
        self.scalars += other.scalars
        self.awake_counts.extend(other.awake_counts)
        self.payload_bytes += other.payload_bytes


def _ledger_flatten(ledger: CommLedger):
    # awake_counts travels as one float64 leaf, as in the reference, so a
    # ledger checkpoints through array-only channels
    return ((ledger.p2p, ledger.matrices, ledger.scalars,
             np.asarray(ledger.awake_counts, np.float64),
             ledger.payload_bytes), None)


def _ledger_unflatten(_aux, children) -> CommLedger:
    p2p, matrices, scalars, awake, payload_bytes = children
    return CommLedger(float(p2p), float(matrices), float(scalars),
                      [int(c) for c in np.asarray(awake).ravel()],
                      float(payload_bytes))


# a CommLedger checkpoints through checkpoint/manager.py as a node of the
# run's state, its list-valued awake_counts rebuilt on restore
_tree.register_node(CommLedger, _ledger_flatten, _ledger_unflatten)
