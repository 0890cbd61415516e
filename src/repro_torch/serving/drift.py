"""Spectrum-drift detection on the ingestor's tracked Ritz state.

The twin of ``repro/serving/drift.py``. Every tick the serving loop asks
whether the subspace it serves is still the subspace of the data it
ingests, reading the two quantities ``StreamingIngestor(track_top=K)``
already keeps per micro-batch:

* the **subspace residual** between the served iterate and the tracked
  top-K Ritz basis (paper eq. (11)), the primary trigger: when the
  stream's population rotates, the tracked basis follows it within a few
  batches and the residual against the frozen served subspace climbs;
* the **eigengap** estimate lambda_K - lambda_{K+1}, logged as the
  re-solve difficulty signal and a secondary trigger on relative gap
  change.

Both are deterministic functions of the ingested stream, so a replay
triggers on the same tick.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.metrics import subspace_error

__all__ = ["DriftStats", "DriftDetector"]


@dataclasses.dataclass
class DriftStats:
    """One tick's drift reading (host floats)."""

    residual: float       # eq. (11) between served Q and tracked top-K basis
    eigengap: float       # tracked lambda_K - lambda_{K+1} estimate
    gap_shift: float      # |eigengap - gap_at_swap| / max(gap_at_swap, eps)
    triggered: bool       # did this reading cross a threshold?


class DriftDetector:
    """Threshold detector over the ingestor's tracked spectrum.

    ``residual_threshold``: trigger when the served subspace's residual
    against the tracked Ritz basis exceeds it. ``gap_shift_threshold``:
    trigger on relative eigengap change against the gap at the last swap
    (``None`` disables it). ``warmup``: ticks after a swap with no trigger,
    so the Ritz iteration mixes before a just-swapped subspace is judged.
    """

    def __init__(self, residual_threshold: float = 0.05,
                 gap_shift_threshold: Optional[float] = None,
                 warmup: int = 3):
        self.residual_threshold = float(residual_threshold)
        self.gap_shift_threshold = gap_shift_threshold
        self.warmup = int(warmup)

    def read(self, ingestor, served_q, *, baseline_gap: float,
             ticks_since_swap: int) -> DriftStats:
        """One tick's reading; pure in (ingestor state, served_q).
        ``served_q`` is a (d, K) tensor on the ingestor's device."""
        basis = ingestor.top_basis()
        residual = float(subspace_error(basis, served_q.to(basis.device)))
        gap = ingestor.eigengap
        gap_shift = abs(gap - baseline_gap) / max(abs(baseline_gap), 1e-12)
        triggered = False
        if ticks_since_swap >= self.warmup:
            triggered = residual > self.residual_threshold
            if self.gap_shift_threshold is not None:
                triggered = triggered or gap_shift > self.gap_shift_threshold
        return DriftStats(residual=residual, eigengap=gap,
                          gap_shift=gap_shift, triggered=triggered)
