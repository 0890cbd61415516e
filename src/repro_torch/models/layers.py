"""Shared building blocks: norms, RoPE, embeddings, dense FFN.

The twin of ``repro/models/layers.py``. Random draws take an explicit
``torch.Generator``; ``gen=None`` is for the ``meta`` device only, where
nothing is drawn (``ModelConfig.param_count``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "swiglu_ffn", "init_dense", "init_norm",
           "embed_lookup", "normal"]


def normal(gen: Optional[torch.Generator], shape, scale: float,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in f32 on ``device``, then cast to ``dtype``,
    as the reference draws ``jax.random.normal(...) * scale``."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def init_norm(d: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def init_dense(gen: Optional[torch.Generator], d_in: int, d_out: int,
               dtype: torch.dtype, device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = (d_in ** -0.5) if scale is None else scale
    return normal(gen, (d_in, d_out), scale, dtype, device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """In f32, cast back to ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding over the two halves of the head dim (not
    interleaved). x: (b, h, s, hd); positions: (b, s) or (s,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None]
    angles = positions[:, None, :, None].float() * freqs     # (b, 1, s, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding gather. tokens: int32 or int64."""
    return F.embedding(tokens, embed)
