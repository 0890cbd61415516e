"""GQA attention: the flash-attention kernel, a plain blockwise path, and the
KV cache. The twin of ``repro/models/attention.py``.

Full sequence (prefill): ``use_kernel=True`` (the default) hands q and the
unexpanded k/v to ``kernels.ops.flash_attention``, which launches the
hand-written kernel on the card; ``use_kernel=False`` expands the kv heads
and runs ``blockwise_attention``, the online softmax over query/key chunks
in plain PyTorch, exactly as the reference's ``use_pallas=False`` does.

Decode: one token against a ring-buffer cache, f32 softmax over the filled
slots, as in the reference. The cache is written in place (the reference
returns an updated copy): ``apply_attn`` returns the same dict it was given.
The reference's SPMD sharding constraints (``act_specs``) do not carry over.

Split over "model" (``model=``, an ``AxisGroup``): the weights are a
rank's blocks, so the head counts come from their shapes: n_heads / tp
query heads and n_kv_heads / tp kv heads, a contiguous block each (the
GQA repeat unchanged); the replicated qkv biases are sliced to them, the
kernel and the cache see only them, and ``wo`` is row-parallel: the
output is this rank's part of the sum, which the caller reduces over
"model".
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from .layers import init_dense, rope

__all__ = ["init_attn", "apply_attn", "init_kv_cache", "blockwise_attention"]

_NEG = -1e30


def _chunk_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_chunk: int = 1024,
                        k_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over query/key chunks. q: (b, h, sq, hd),
    k/v: (b, h, skv, hd), the same head count."""
    b, h, sq, hd = q.shape
    skv = k.shape[2]
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, skv)
    if sq % q_chunk or skv % k_chunk:
        raise ValueError(f"sq={sq}, skv={skv} not multiples of the chunks "
                         f"({q_chunk}, {k_chunk})")
    scale = hd ** -0.5
    dev = q.device
    outs = []
    for q0 in range(0, sq, q_chunk):
        qblk = q[:, :, q0:q0 + q_chunk].float()
        qpos = torch.arange(q0, q0 + q_chunk, device=dev)
        m = torch.full((b, h, q_chunk, 1), _NEG, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, q_chunk, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        for k0 in range(0, skv, k_chunk):
            kpos = torch.arange(k0, k0 + k_chunk, device=dev)
            logits = torch.einsum("bhqd,bhkd->bhqk", qblk,
                                  k[:, :, k0:k0 + k_chunk].float()) * scale
            mask = _chunk_mask(qpos, kpos, causal, window)
            logits = logits.masked_fill(~mask, _NEG)
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            p = torch.exp(logits - m_new).masked_fill(~mask, 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = alpha * acc + torch.einsum(
                "bhqk,bhkd->bhqd", p, v[:, :, k0:k0 + k_chunk].float())
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((acc / l).to(q.dtype))
    return torch.cat(outs, dim=2)


def init_attn(gen: Optional[torch.Generator], cfg: ModelConfig,
              device: torch.device) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.torch_dtype
    p = {
        "wq": init_dense(gen, d, nq * hd, dt, device),
        "wk": init_dense(gen, d, nkv * hd, dt, device),
        "wv": init_dense(gen, d, nkv * hd, dt, device),
        "wo": init_dense(gen, nq * hd, d, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nq * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((nkv * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((nkv * hd,), dtype=dt, device=device)
    return p


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  device: torch.device, n_kv_heads: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """Stacked-over-layers ring-buffer KV cache for attention layers, of
    ``n_kv_heads`` heads (default all; a model rank's share when split).

    With ``cfg.kv_quant`` entries are int8 with a per-(token, head) absmax
    scale: half the capacity and read traffic of bf16.
    """
    nkv = cfg.n_kv_heads if n_kv_heads is None else n_kv_heads
    shape = (n_layers, batch, nkv, max_len, cfg.hd)
    if cfg.kv_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=device),
        }
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def _quantize_kv(x: torch.Tensor):
    """(b, kv, 1, hd) -> int8 values + f32 absmax scale."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / scale * 127.0), -127, 127)
    return q.to(torch.int8), scale


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, rank: int = 0):
    """q (b, nq, s, hd), k/v (b, nkv, s, hd) with RoPE, for the heads of
    model rank ``rank`` (all of them unsplit)."""
    b, s, _ = x.shape
    hd = cfg.hd
    nq, nkv = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        bq, bk, bv = p["bq"], p["bk"], p["bv"]
        if nq != cfg.n_heads:
            bq = bq[rank * nq * hd:(rank + 1) * nq * hd]
            bk = bk[rank * nkv * hd:(rank + 1) * nkv * hd]
            bv = bv[rank * nkv * hd:(rank + 1) * nkv * hd]
        q, k, v = q + bq, k + bk, v + bv
    q = q.reshape(b, s, nq, hd).transpose(1, 2)
    k = k.reshape(b, s, nkv, hd).transpose(1, 2)
    v = v.reshape(b, s, nkv, hd).transpose(1, 2)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_attn(p, x: torch.Tensor, cfg: ModelConfig, *,
               window: Optional[int] = None,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               cache_index: Optional[int] = None, use_kernel: bool = True,
               model=None):
    """Full-sequence path (cache is None) or single-step decode path.

    Decode: x is (b, 1, d); cache = {"k", "v"} slabs (b, nkv, S, hd) of THIS
    layer (views into the stacked cache), written in place at slot
    ``cache_index % S``; ``cache_index`` is the host's step count, so no
    step waits on the device. ``model``: the "model" ``AxisGroup`` when
    ``p`` holds a rank's heads (module docstring); the output is then that
    rank's partial sum. Returns (out, cache).
    """
    b, s, _ = x.shape
    if cache is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    else:
        positions = torch.full((b, 1), cache_index, dtype=torch.int32,
                               device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions,
                           model.index if model is not None else 0)
    nq, nkv, hd = q.shape[1], k.shape[1], cfg.hd
    rep = nq // nkv
    if rep != cfg.n_heads // cfg.n_kv_heads:
        raise ValueError(f"{nq} query heads over {nkv} kv heads: the GQA "
                         f"repeat of {cfg.name} is "
                         f"{cfg.n_heads // cfg.n_kv_heads}")

    if cache is None:
        if use_kernel:
            out = kops.flash_attention(q, k, v, causal=True, window=window)
        else:
            out = blockwise_attention(
                q, k.repeat_interleave(rep, dim=1),
                v.repeat_interleave(rep, dim=1), causal=True, window=window)
    else:
        max_len = cache["k"].shape[2]
        slot = cache_index % max_len    # ring buffer (SWA: max_len == window)
        if cfg.kv_quant:
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            cache["k"][:, :, slot:slot + 1] = kq
            cache["v"][:, :, slot:slot + 1] = vq
            cache["k_scale"][:, :, slot:slot + 1] = ks
            cache["v_scale"][:, :, slot:slot + 1] = vs
            kd = cache["k"].float() * cache["k_scale"] / 127.0
            vd = cache["v"].float() * cache["v_scale"] / 127.0
        else:
            cache["k"][:, :, slot:slot + 1] = k
            cache["v"][:, :, slot:slot + 1] = v
            kd, vd = cache["k"].float(), cache["v"].float()
        # each query head's group of kv heads, without expanding the cache:
        # q (b, nkv, rep, 1, hd) against k (b, nkv, S, hd)
        qg = q.float().reshape(b, nkv, rep, s, hd)
        logits = torch.einsum("bgrqd,bgkd->bgrqk", qg, kd) * (hd ** -0.5)
        # valid = filled slots only (ring: all slots < min(idx + 1, S))
        filled = min(cache_index + 1, max_len)
        logits[..., filled:] = _NEG
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgrqk,bgkd->bgrqd", probs, vd)
        out = out.reshape(b, nq, s, hd).to(x.dtype)

    out = out.transpose(1, 2).reshape(b, s, nq * hd)
    return out @ p["wo"], cache
