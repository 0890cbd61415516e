"""PSA data generators: Gaussian data with a controlled r-th eigengap, a
power-law stand-in for natural-image spectra, and the sample-wise /
feature-wise partitioners; and the LM token stream.

The PSA generators draw from ``np.random.default_rng`` exactly as
``repro/data/pipeline.py`` does, so the arrays are the reference's bit for
bit before the float32 cast. ``make_lm_batch`` cannot replay
``jax.random.randint``: it has the reference's shapes and labels rule, and
draws from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

__all__ = ["gaussian_eigengap_data", "spectrum_matched_data",
           "partition_samples", "partition_features", "make_lm_batch"]


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
    evals = np.arange(1, d + 1, dtype=np.float64) ** (-alpha)
    u = np.linalg.qr(rng.standard_normal((d, d)))[0]
    x = (u * np.sqrt(evals)) @ rng.standard_normal((d, n))
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
