"""PSA data generators: Gaussian data with a controlled r-th eigengap, a
power-law stand-in for natural-image spectra, and the sample-wise /
feature-wise partitioners; their stateless micro-batch streams; and the LM
token stream.

The PSA generators and the streams' populations (C, Q_true, the factor L)
draw from ``np.random.default_rng`` exactly as ``repro/data/pipeline.py``
does, so those arrays are the reference's bit for bit before the float32
cast. The samples cannot replay ``jax.random``: a stream's batch is
``L @ N(0, I)`` from a ``torch.Generator`` on the stream's device, seeded by
(seed, step), so a batch is a pure function of (seed, step) on a given
device and a restarted reader replays the same stream. On the card the
batch is drawn there, with no copy from the host. ``make_lm_batch`` has the
reference's shapes and labels rule and draws from a CPU ``torch.Generator``.
Parity tests hand the reference's batches to the port's consumers instead.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

__all__ = ["gaussian_eigengap_data", "spectrum_matched_data",
           "partition_samples", "partition_features", "make_lm_batch",
           "synthetic_lm_stream", "spectrum_matched_stream",
           "eigengap_stream", "drifting_eigengap_stream", "stream_seed"]

BatchFn = Callable[[int, int], torch.Tensor]


def _eigengap_cov(rng, d: int, r: int, gap: float, lead: float,
                  repeated_top: bool):
    """Controlled-gap population covariance C = U diag(evals) U^T."""
    if repeated_top:
        top = np.full(r, lead)
    else:
        top = np.linspace(lead, lead * 0.6, r)
    tail_lead = top[-1] * gap
    tail = np.linspace(tail_lead, tail_lead * 0.1, d - r)
    evals = np.concatenate([top, tail])
    u = np.linalg.qr(rng.standard_normal((d, d)))[0]
    return u @ np.diag(evals) @ u.T, u


def _spectrum_factor(rng, d: int, alpha: float) -> np.ndarray:
    """Power-law factor L with L L^T spectrum lambda_i ~ i^-alpha (shared by
    ``spectrum_matched_data`` and ``spectrum_matched_stream``)."""
    evals = np.arange(1, d + 1, dtype=np.float64) ** (-alpha)
    u = np.linalg.qr(rng.standard_normal((d, d)))[0]
    return u * np.sqrt(evals)


def _f32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def gaussian_eigengap_data(d: int, n: int, r: int, gap: float, seed: int = 0,
                           lead: float = 3.0, repeated_top: bool = False, *,
                           device: DeviceLike = None):
    """X ~ N(0, C) with lambda_{r+1}/lambda_r == gap exactly.

    Returns float32 tensors (X (d, n), C (d, d), Q_true (d, r)) on
    ``device``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    c, u = _eigengap_cov(rng, d, r, gap, lead, repeated_top)
    x = np.linalg.cholesky(c + 1e-12 * np.eye(d)) @ rng.standard_normal((d, n))
    return _f32(x, dev), _f32(c, dev), _f32(u[:, :r], dev)


def spectrum_matched_data(d: int, n: int, seed: int = 0, alpha: float = 1.2,
                          *, device: DeviceLike = None) -> torch.Tensor:
    """Power-law spectrum lambda_i ~ i^-alpha (natural-image decay shape)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = _spectrum_factor(rng, d, alpha) @ rng.standard_normal((d, n))
    return _f32(x, dev)


def partition_samples(x: torch.Tensor, n_nodes: int) -> List[torch.Tensor]:
    """Split columns (samples) evenly over nodes (the sample-wise case)."""
    per = x.shape[1] // n_nodes
    return [x[:, i * per:(i + 1) * per] for i in range(n_nodes)]


def partition_features(x: torch.Tensor, n_nodes: int) -> List[torch.Tensor]:
    """Split rows (features) evenly over nodes (the feature-wise case)."""
    d = x.shape[0]
    per = d // n_nodes
    return [x[i * per:(d if i == n_nodes - 1 else (i + 1) * per)]
            for i in range(n_nodes)]


# ---------------------------------------------------------------------------
# stateless-seeded PSA sample streams (streaming covariance ingestion)
# ---------------------------------------------------------------------------
def stream_seed(seed: int, step: int) -> int:
    """The 64-bit generator seed of (seed, step), from a SeedSequence, so
    neighbouring steps and seeds get unrelated streams."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0])


def _stream_batch_fn(factor: torch.Tensor, seed: int) -> BatchFn:
    """Wrap a (d, d) covariance factor L into a pure micro-batch function.

    ``batch(step, m) = L @ N(0, I)``, the normal draws from a generator on
    L's device seeded by ``stream_seed(seed, step)``: step -> batch is a
    pure function of (seed, step) on that device, so a restarted ingestor
    replays the same stream with no reader state beyond the next step.
    """
    dev = factor.device

    def batch(step: int, m: int) -> torch.Tensor:
        gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, step))
        z = torch.randn((factor.shape[0], m), generator=gen, device=dev,
                        dtype=torch.float32)
        return factor @ z

    return batch


def spectrum_matched_stream(d: int, seed: int = 0, alpha: float = 1.2, *,
                            device: DeviceLike = None) -> BatchFn:
    """Stateless micro-batch twin of ``spectrum_matched_data``: returns
    ``batch(step, m) -> (d, m)`` drawing from the same power-law population
    (the mixing basis depends only on ``seed``, the samples on (seed,
    step))."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return _stream_batch_fn(_f32(_spectrum_factor(rng, d, alpha), dev), seed)


def eigengap_stream(d: int, r: int, gap: float, seed: int = 0,
                    lead: float = 3.0, repeated_top: bool = False, *,
                    device: DeviceLike = None):
    """Stateless micro-batch twin of ``gaussian_eigengap_data``.

    Returns ``(batch_fn, C, Q_true)``: the same controlled-eigengap
    population (``_eigengap_cov``, the reference's bits before the f32
    cast), its samples as pure (seed, step) micro-batches.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    c, u = _eigengap_cov(rng, d, r, gap, lead, repeated_top)
    factor = np.linalg.cholesky(c + 1e-12 * np.eye(d))
    return (_stream_batch_fn(_f32(factor, dev), seed), _f32(c, dev),
            _f32(u[:, :r], dev))


def drifting_eigengap_stream(d: int, r: int, gap: float, shift_at: int,
                             seed: int = 0, lead: float = 3.0,
                             shift_seed: Optional[int] = None,
                             shift_lead: Optional[float] = None, *,
                             device: DeviceLike = None):
    """An ``eigengap_stream`` whose population changes at step ``shift_at``.

    Steps ``< shift_at`` draw from the pre-shift population, later steps
    from an independently rotated one (``shift_seed``, default ``seed +
    101``) with the same eigengap profile and leading eigenvalue
    ``shift_lead`` (default ``lead``). Still a pure function of (seed,
    step). Returns ``(batch_fn, (C0, Q0), (C1, Q1))``.
    """
    if shift_seed is None:
        shift_seed = seed + 101
    if shift_lead is None:
        shift_lead = lead
    fn0, c0, q0 = eigengap_stream(d, r, gap, seed=seed, lead=lead,
                                  device=device)
    fn1, c1, q1 = eigengap_stream(d, r, gap, seed=shift_seed,
                                  lead=shift_lead, device=device)

    def batch(step: int, m: int) -> torch.Tensor:
        return fn0(step, m) if step < shift_at else fn1(step, m)

    return batch, (c0, q0), (c1, q1)


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------
def make_lm_batch(cfg, seed: int, step: int, batch: int, seq: int,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Pure function (seed, step) -> batch of int32 tokens; labels = next
    token. ``cfg`` is a ``configs.base.ModelConfig``.

    The draw comes from a CPU ``torch.Generator`` seeded from (seed, step),
    so a batch is the same on every device; it is then moved to ``device``.
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))
    shape = ((batch, seq + 1, cfg.n_codebooks)
             if cfg.frontend == "audio_codec" else (batch, seq + 1))
    toks = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         dtype=torch.int64).to(torch.int32)
    out = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    if cfg.frontend == "vlm_patches":
        out["patch_embeds"] = 0.02 * torch.randn(
            (batch, cfg.n_prefix_tokens, cfg.d_model), generator=gen).to(dev)
    return out


def synthetic_lm_stream(cfg, seed: int, batch: int, seq: int,
                        start_step: int = 0, device: DeviceLike = None
                        ) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
    """Infinite restartable iterator of (step, ``make_lm_batch``)."""
    step = start_step
    while True:
        yield step, make_lm_batch(cfg, seed, step, batch, seq, device=device)
        step += 1
