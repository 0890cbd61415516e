"""Batched projection/compression query path for the PSA service.

The twin of ``repro/serving/query.py``. Queries are the two PSA inference
primitives: **project** (``y = Q^T x``, the r-dim code) and **reconstruct**
(``Q Q^T x``, the rank-r approximation). The path is built for graceful
degradation, not peak throughput:

* **bounded admission queue**: ``submit`` on a full queue returns False
  and counts a shed request;
* **per-request deadlines**: answers that would arrive late are counted
  ``expired`` and dropped;
* **batched execution**: ``process`` drains up to ``max_batch`` requests
  into one product against the served Q, a tensor on the card that the
  service publishes whole at a swap, so a batch never sees a half-swapped
  subspace (the Q is read once a batch);
* **p50/p99 accounting**: latency = queue wait + batch compute + any
  injected delay, observed into an ``obs.registry.Histogram`` (a shared
  ``registry=`` exposes it with the service's other metrics).

``ChaosHooks.query_delay(req_id)`` gives a seeded per-request delay that
is **accounted, never slept**: it can push a request past its deadline,
deterministically for a given (plan seed, req_id), while the wall clock
stays fast.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..obs import Histogram

__all__ = ["QueryRequest", "QueryPath"]


def _project(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return q.T @ x


def _reconstruct(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return q @ (q.T @ x)


@dataclasses.dataclass
class QueryRequest:
    """One admitted query: payload column + its admission bookkeeping."""

    req_id: int
    x: np.ndarray          # (d,) query vector
    submitted_at: float    # clock at admission
    deadline: float        # absolute clock; late answers expire


class QueryPath:
    """Bounded, deadline-aware, batched query front-end.

    ``capacity`` bounds the admission queue (overflow -> shed).
    ``max_batch`` bounds one ``process`` drain. ``deadline_s`` is the
    per-request latency budget. ``mode`` is ``"project"`` or
    ``"reconstruct"``. ``hooks`` (a ``streaming.chaos.ChaosHooks`` or None)
    supplies seeded injected delays. ``device`` is where the products run
    (CUDA by default).
    """

    def __init__(self, *, capacity: int = 64, max_batch: int = 16,
                 deadline_s: float = 0.25, mode: str = "project",
                 hooks=None, clock=time.monotonic, registry=None,
                 device: DeviceLike = None):
        if mode not in ("project", "reconstruct"):
            raise ValueError(f"unknown query mode: {mode}")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.max_batch = int(max_batch)
        self.deadline_s = float(deadline_s)
        self.mode = mode
        self.hooks = hooks
        self.clock = clock
        self.registry = registry
        self._queue: List[QueryRequest] = []
        self.submitted = 0
        self.answered = 0
        self.shed = 0           # refused at admission (queue full)
        self.expired = 0        # admitted but answer would miss its deadline
        # per-instance histogram unless a shared registry is supplied: two
        # services must not pollute each other's percentiles
        self.latency = (registry.histogram("query_latency_seconds")
                        if registry is not None else Histogram())

    def __len__(self) -> int:
        return len(self._queue)

    def warmup(self, d: int, r: int) -> None:
        """Run both products once, so the first query does not pay the
        device's first matmuls (on the card: the CUDA context and the
        cuBLAS handle)."""
        q = torch.zeros((d, r), dtype=torch.float32, device=self.device)
        x = torch.zeros((d, 1), dtype=torch.float32, device=self.device)
        _project(q, x).cpu()
        _reconstruct(q, x).cpu()

    def submit(self, req_id: int, x) -> bool:
        """Admit one query; False (and a shed count) when the queue is full."""
        self.submitted += 1
        if self.registry is not None:
            self.registry.counter("query_submitted_total").inc()
        if len(self._queue) >= self.capacity:
            self.shed += 1
            if self.registry is not None:
                self.registry.counter("query_shed_total").inc()
            return False
        now = self.clock()
        self._queue.append(QueryRequest(
            req_id=int(req_id), x=np.asarray(x, np.float32),
            submitted_at=now, deadline=now + self.deadline_s))
        return True

    def process(self, served_q) -> List[Tuple[int, np.ndarray]]:
        """Drain up to ``max_batch`` requests against the served subspace
        (a (d, r) tensor, or an array copied to the device).

        Returns ``[(req_id, answer), ...]`` for the requests that made their
        deadline; late ones are counted ``expired`` and dropped. Latency is
        queue wait + batch compute + injected delay (added, never slept).
        """
        if not self._queue:
            return []
        batch = self._queue[:self.max_batch]
        self._queue = self._queue[self.max_batch:]
        q = torch.as_tensor(served_q, dtype=torch.float32, device=self.device)
        x = torch.from_numpy(np.stack([req.x for req in batch], axis=1)).to(
            self.device)
        kernel = _project if self.mode == "project" else _reconstruct
        out = kernel(q, x).cpu().numpy()
        done = self.clock()
        answers: List[Tuple[int, np.ndarray]] = []
        for j, req in enumerate(batch):
            injected = (self.hooks.query_delay(req.req_id)
                        if self.hooks is not None else 0.0)
            latency = (done - req.submitted_at) + injected
            if done + injected > req.deadline:
                self.expired += 1
                if self.registry is not None:
                    self.registry.counter("query_expired_total").inc()
                continue
            self.answered += 1
            self.latency.observe(latency)
            answers.append((req.req_id, out[:, j]))
        if self.registry is not None:
            self.registry.counter("query_answered_total").inc(len(answers))
        return answers

    def drain_expired(self) -> int:
        """Expire (without answering) queued requests already past deadline."""
        now = self.clock()
        live = [r for r in self._queue if r.deadline > now]
        n_expired = len(self._queue) - len(live)
        self.expired += n_expired
        self._queue = live
        if n_expired and self.registry is not None:
            self.registry.counter("query_expired_total").inc(n_expired)
        return n_expired

    def summary(self) -> dict:
        """Counters + latency percentiles (seconds), the reference's keys."""
        p50: Optional[float] = self.latency.p50
        p99: Optional[float] = self.latency.p99
        return {
            "submitted": self.submitted,
            "answered": self.answered,
            "shed": self.shed,
            "expired": self.expired,
            "queued": len(self._queue),
            "p50_s": None if p50 is None else float(p50),
            "p99_s": None if p99 is None else float(p99),
        }
