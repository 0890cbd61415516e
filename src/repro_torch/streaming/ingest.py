"""Online covariance ingestion: per-node sketches fed by micro-batches.

The twin of ``repro/streaming/ingest.py``. The paper materializes each
node's covariance ``M_i = X_i X_i^T / n_i`` up front; at production scale
the samples arrive in micro-batches and no host holds its whole block. Two
per-node sketches, each ONE stacked state over all simulated nodes (one
batched product a micro-batch):

* ``CovSketch``: the exact running second moment ``sum_t X_t X_t^T`` plus a
  sample count, updated by one batched ``baddbmm`` a micro-batch.
  ``cov_stack()`` is the (N, d, d) operand stack ``sdot`` expects, equal to
  the batch pipeline's covariances up to f32 summation order.
* ``FrequentDirections``: the deterministic Liberty sketch for d where the
  (d, d) second moment does not fit: per node an (ell, d) row sketch B with
  ``||X X^T - B^T B||_2 <= shrink_loss`` (the accumulated shrink mass),
  shrunk by one batched SVD a micro-batch.

``StreamingIngestor`` drives either sketch from a stateless stream
(``data/pipeline``'s ``*_stream``): each micro-batch is split over nodes by
``partition_samples``, so node i's samples are the concatenation of its
per-batch shards. Its whole state (the sketch, the next stream step and,
with ``track_top=K``, a top-(K+1) Rayleigh-Ritz track of the global
spectrum) checkpoints through ``checkpoint/manager.py`` under the
reference's leaf names; a restored ingestor replays the same remainder of
the stream, bit for bit on the same device (every product here has a fixed
order). The Ritz track is what the serving layer's drift detector reads.

The Ritz basis starts from ``orthonormal_init`` on a CPU generator seeded
by ``ritz_seed`` (a torch stream, not the reference's ``jax.random`` one);
``ritz_init`` injects a basis instead, as the parity tests do with the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import _tree
from .._device import DeviceLike, resolve_device
from ..core.linalg import orthonormal_init
from ..data.pipeline import partition_samples

__all__ = ["CovSketch", "FrequentDirections", "StreamingIngestor",
           "ritz_step"]


def _require_samples(counts: torch.Tensor) -> None:
    """Fail at the call site instead of emitting a 0/0 all-NaN cov stack."""
    if not float(counts.min()) > 0:
        raise ValueError("cov_stack() before any batch was ingested — "
                         "call ingest() first")


@dataclasses.dataclass
class CovSketch:
    """Exact stacked running second moment: (N, d, d) + per-node counts."""

    second_moment: torch.Tensor      # (N, d, d) running sum X X^T
    counts: torch.Tensor             # (N,) samples seen per node

    @classmethod
    def init(cls, n_nodes: int, d: int,
             device: DeviceLike = None) -> "CovSketch":
        dev = resolve_device(device)
        return cls(torch.zeros((n_nodes, d, d), dtype=torch.float32,
                               device=dev),
                   torch.zeros((n_nodes,), dtype=torch.float32, device=dev))

    def update(self, blocks: torch.Tensor) -> "CovSketch":
        """One micro-batch, blocks (N, d, m): one batched product."""
        sm = torch.baddbmm(self.second_moment, blocks, blocks.mT)
        return CovSketch(sm, self.counts + float(blocks.shape[2]))

    def cov_stack(self) -> torch.Tensor:
        """(N, d, d) per-node covariances M_i = sum X X^T / n_i."""
        _require_samples(self.counts)
        return self.second_moment / self.counts[:, None, None]

    def apply_sum(self, v: torch.Tensor) -> torch.Tensor:
        """(sum_n X_n X_n^T) @ v without forming the global matrix."""
        return (self.second_moment @ v).sum(0)


@dataclasses.dataclass
class FrequentDirections:
    """Stacked per-node Frequent-Directions sketches: (N, ell, d).

    Deterministic and ell << d memory: per node ``||X X^T - B^T B||_2 <=
    shrink_loss`` (Liberty '13, Ghashami et al. '16)."""

    sketch: torch.Tensor             # (N, ell, d)
    counts: torch.Tensor             # (N,)
    shrink_loss: torch.Tensor        # (N,) accumulated spectral-error bound

    @classmethod
    def init(cls, n_nodes: int, d: int, ell: int,
             device: DeviceLike = None) -> "FrequentDirections":
        if ell > d:
            raise ValueError(f"sketch size ell={ell} exceeds d={d} — use the "
                             "exact CovSketch instead")
        dev = resolve_device(device)
        zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        return cls(zeros(n_nodes, ell, d), zeros(n_nodes), zeros(n_nodes))

    @property
    def ell(self) -> int:
        return self.sketch.shape[1]

    def update(self, blocks: torch.Tensor) -> "FrequentDirections":
        """One micro-batch, blocks (N, d, m): stack the new rows under the
        sketch, one batched SVD, subtract the ell-th squared singular value
        from every direction (zeroing at least one kept row) and keep the
        top ell. The subtracted mass is the step's addition to the bound."""
        ell = self.ell
        buf = torch.cat([self.sketch, blocks.mT], dim=1)
        _, s, vh = torch.linalg.svd(buf, full_matrices=False)
        delta = s[:, ell - 1] ** 2
        shrunk = torch.sqrt(torch.clamp(s ** 2 - delta[:, None], min=0.0))
        return FrequentDirections(shrunk[:, :ell, None] * vh[:, :ell],
                                  self.counts + float(blocks.shape[2]),
                                  self.shrink_loss + delta)

    def cov_stack(self) -> torch.Tensor:
        """(N, d, d) approximate covariances B^T B / n_i (for moderate d)."""
        _require_samples(self.counts)
        return (self.sketch.mT @ self.sketch) / self.counts[:, None, None]

    def apply_sum(self, v: torch.Tensor) -> torch.Tensor:
        """(sum_n B_n^T B_n) @ v: two (ell, d) products, never a (d, d)."""
        return (self.sketch.mT @ (self.sketch @ v)).sum(0)


_tree.register_node(CovSketch, lambda s: ((s.second_moment, s.counts), None),
                    lambda _aux, children: CovSketch(*children))
_tree.register_node(
    FrequentDirections,
    lambda s: ((s.sketch, s.counts, s.shrink_loss), None),
    lambda _aux, children: FrequentDirections(*children))


def ritz_step(sketch, basis: torch.Tensor):
    """One subspace-iteration + Rayleigh-Ritz step of the tracked basis.

    ``basis`` (d, k) orthonormal -> (new basis, Ritz values descending):
    two sketch-applies, a QR of (d, k) and an eigh of (k, k), against the
    sketch's accumulated global second moment."""
    total = torch.clamp(sketch.counts.sum(), min=1.0)
    v, _ = torch.linalg.qr(sketch.apply_sum(basis))
    h = v.T @ sketch.apply_sum(v) / total
    h = 0.5 * (h + h.T)
    vals, vecs = torch.linalg.eigh(h)
    return v @ vecs.flip(-1), vals.flip(-1)


class StreamingIngestor:
    """Drive N per-node sketches from a stateless micro-batch stream.

    ``batch_fn(step, m) -> (d, m)`` must be a pure function of (seed, step);
    it may return a tensor or an array (moved to ``device``). Every
    micro-batch is column-sharded over nodes with ``partition_samples``.
    ``state()`` / ``restore()`` round-trip the ingestion state (sketch, next
    step, and the Ritz basis and values when ``track_top`` is set).
    """

    def __init__(self, *, n_nodes: int, d: int,
                 batch_fn: Callable[[int, int], torch.Tensor],
                 batch_size: int, sketch: str = "exact",
                 ell: Optional[int] = None, start_step: int = 0,
                 track_top: Optional[int] = None, ritz_seed: int = 0,
                 ritz_init=None, device: DeviceLike = None):
        if batch_size % n_nodes:
            raise ValueError(f"batch_size={batch_size} must divide evenly "
                             f"over {n_nodes} nodes (partition_samples "
                             "drops remainder columns)")
        self.device = resolve_device(device)
        self.n_nodes = n_nodes
        self.d = d
        self.batch_fn = batch_fn
        self.batch_size = batch_size
        self.step = start_step
        if sketch == "exact":
            self.sketch = CovSketch.init(n_nodes, d, self.device)
        elif sketch == "fd":
            if ell is None:
                raise ValueError("sketch='fd' needs ell")
            self.sketch = FrequentDirections.init(n_nodes, d, ell,
                                                  self.device)
        else:
            raise ValueError(f"unknown sketch kind: {sketch}")
        self.track_top = track_top
        self._ritz_basis = self._ritz_vals = None
        if track_top is not None:
            if not 0 < track_top < d:
                raise ValueError(f"track_top={track_top} needs a spare "
                                 f"direction: require 0 < K < d={d} so the "
                                 "(K+1)-th Ritz value exists for the gap")
            if ritz_init is None:
                ritz_init = orthonormal_init(
                    torch.Generator().manual_seed(ritz_seed), d,
                    track_top + 1)
            self._ritz_basis = self._on_device(ritz_init)
            self._ritz_vals = torch.zeros((track_top + 1,),
                                          dtype=torch.float32,
                                          device=self.device)

    def _on_device(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, np.float32))
        return a.to(device=self.device, dtype=torch.float32)

    def ingest(self, n_batches: int = 1) -> "StreamingIngestor":
        """Consume the next ``n_batches`` stream steps into the sketches."""
        for _ in range(n_batches):
            x = self._on_device(self.batch_fn(self.step, self.batch_size))
            blocks = torch.stack(partition_samples(x, self.n_nodes))
            # a profiler label only (no cost unless a profile records)
            with torch.profiler.record_function("ingest_sketch_update"):
                self.sketch = self.sketch.update(blocks)
            if self._ritz_basis is not None:
                self._ritz_basis, self._ritz_vals = ritz_step(
                    self.sketch, self._ritz_basis)
            self.step += 1
        return self

    # -- tracked spectrum (drift detector inputs) ---------------------------
    @property
    def ritz_values(self) -> Optional[np.ndarray]:
        """(K+1,) descending Ritz estimates of the global eigenvalues."""
        return (None if self._ritz_vals is None
                else self._ritz_vals.cpu().numpy())

    @property
    def eigengap(self) -> float:
        """Tracked lambda_K - lambda_{K+1} estimate (Alg. 1's rate driver)."""
        if self._ritz_vals is None:
            raise ValueError("eigengap needs track_top set at construction")
        vals = self.ritz_values
        return float(vals[self.track_top - 1] - vals[self.track_top])

    def top_basis(self) -> torch.Tensor:
        """(d, K) tracked leading Ritz basis (the drift reference)."""
        if self._ritz_basis is None:
            raise ValueError("top_basis needs track_top set at construction")
        return self._ritz_basis[:, :self.track_top]

    def cov_stack(self) -> torch.Tensor:
        """The evolving (N, d, d) operand stack for the fused executors."""
        return self.sketch.cov_stack()

    @property
    def samples_per_node(self) -> np.ndarray:
        return self.sketch.counts.cpu().numpy()

    # -- checkpointing ------------------------------------------------------
    def state(self) -> dict:
        """The snapshot tree for ``CheckpointManager.save``: the reference's
        leaf names (``step``, ``sketch/0`` ...; ``ritz_basis`` and
        ``ritz_vals`` only when tracking is on)."""
        tree = {"step": np.int32(self.step), "sketch": self.sketch}
        if self._ritz_basis is not None:
            tree["ritz_basis"] = self._ritz_basis
            tree["ritz_vals"] = self._ritz_vals
        return tree

    def restore(self, tree: dict) -> "StreamingIngestor":
        self.step = int(tree["step"])
        self.sketch = tree["sketch"]
        if self._ritz_basis is not None:
            self._ritz_basis = self._on_device(tree["ritz_basis"])
            self._ritz_vals = self._on_device(tree["ritz_vals"])
        return self
