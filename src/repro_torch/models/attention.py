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
rank's blocks as ``param_specs`` cuts them, and the rank computes whole
query heads, its ``sharding.share`` of them (``launch/mesh.share_of``):
n_heads / tp of them where they divide, else the first n_heads % tp ranks
one more, and where n_heads < tp some ranks none. Where the heads divide,
``wq``'s column block is the rank's heads and ``wo`` is row-parallel: the
output is this rank's part of the sum, which the caller reduces over
"model". Where they do not, ``wq``'s block (or the whole ``wq``, where n_heads
hd does not divide) may end mid-head: the rank projects q on it, gathers it
whole over "model" (``take_share``: ``gather_summed_from_model``, each rank
reading its heads) before RoPE and keeps its heads; its heads' output is
placed in the whole width and regrouped to ``wo``'s row block by a
reduce-scatter (``put_share``: ``scatter_summed_to_model``; a whole ``wo``
is read at its heads' rows instead), then the same f32 partial product.
Where the kv heads divide over "model", a rank holds n_kv_heads / tp of
them (the GQA repeat unchanged); the replicated qkv biases are sliced to
them, the kernel and the cache see only them. Where they do not
(recurrentgemma's one kv head, or query heads shared out unevenly), ``wk`` /
``wv`` hold a block of the kv heads' columns: each rank projects its
columns and gathers the whole k and v (``gather_summed_from_model``, the
gradient summed over "model": each rank's query heads read them), before
RoPE, which pairs columns across the block's edge. The full path runs the
kernel on the rank's query heads against the kv heads they read
(``sharding.kv_read``: two or more where its heads straddle a GQA group),
query head i of the launch reading kv head (h0 + i) // group - h0 // group
(``kernels/ops.flash_attention(..., group=, q_head0=h0)``). A rank with no
heads launches no kernel and joins every collective.

Decode by length (``length=``, the group ``sharding.length_axes`` names:
"model" where the kv heads do not divide over it; where the batch does not
divide over the data axes, the data axes first): rank r of the n in the
group holds ring slots [r S / n, (r + 1) S / n) of its kv heads (its own
where they divide over "model", else every one); the rank that owns the
step's slot writes it; each rank takes a partial softmax of its query
heads over its filled slots, as (max, sum, weighted v), the partials are
gathered over the group and combined. Where the kv heads do not divide,
q is projected for every query head (gathered over "model" as above),
every head's partials travel in the one gather, and each rank keeps its
heads' rows. A rank with no filled slot weighs 0. A ring that does not
divide over the group is whole on every rank (``length=None``): every rank
writes the slot of every kv head and reads those its query heads need
(its heads padded to whole GQA groups), with no combine.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from ..kernels.ref import expand_kv
from ..launch.mesh import (gather_summed_from_model, partial_product,
                           put_share, share_of, split_axis, take_share)
from .layers import init_dense, rope
from .sharding import kv_read

__all__ = ["init_attn", "apply_attn", "init_kv_cache", "blockwise_attention",
           "kv_whole"]

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


def kv_whole(cfg: ModelConfig, model) -> bool:
    """Whether a split over ``model`` leaves the kv heads undivided: each
    rank reads those its query heads need, and its cache holds all of them
    (module docstring)."""
    return split_axis(model) and cfg.n_kv_heads % model.size != 0


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, heads, model=None, kv=None):
    """q (b, nq, s, hd) of the query heads ``heads`` [start, stop) (all of
    them unsplit), k/v (b, nkv, s, hd) with RoPE. q is projected on
    ``wq``'s block and, where that is not those heads' columns, gathered
    whole over ``model`` and narrowed (``take_share``). ``kv``: where the
    kv heads do not divide over ``model``, the kv heads [start, stop) to
    return, gathered whole (module docstring)."""
    b, s, _ = x.shape
    hd = cfg.hd
    nq = heads[1] - heads[0]
    q = take_share(x @ p["wq"], (heads[0] * hd, heads[1] * hd),
                   cfg.n_heads * hd, model)
    k = x @ p["wk"]
    v = x @ p["wv"]
    if kv is None:
        nkv = p["wk"].shape[-1] // hd
        rank = model.index if split_axis(model) else 0
        cols = slice(rank * nkv * hd, (rank + 1) * nkv * hd)
    else:
        if k.shape[-1] != cfg.n_kv_heads * hd:     # a block of the columns
            k = gather_summed_from_model(k, model, dim=-1)
            v = gather_summed_from_model(v, model, dim=-1)
        nkv = kv[1] - kv[0]
        cols = slice(kv[0] * hd, kv[1] * hd)
        k, v = k[..., cols], v[..., cols]
    if cfg.qkv_bias:
        bq, bk, bv = p["bq"], p["bk"], p["bv"]
        if nq != cfg.n_heads:
            bq = bq[heads[0] * hd:heads[1] * hd]
        if nkv != cfg.n_kv_heads:
            bk, bv = bk[cols], bv[cols]
        q, k, v = q + bq, k + bk, v + bv
    q = q.reshape(b, s, nq, hd).transpose(1, 2)
    k = k.reshape(b, s, nkv, hd).transpose(1, 2)
    v = v.reshape(b, s, nkv, hd).transpose(1, 2)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _write_slot(cache, k: torch.Tensor, v: torch.Tensor, slot: int,
                quant: bool) -> None:
    """k, v (b, nkv, 1, hd) into ring slot ``slot`` of this layer's cache."""
    if quant:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache["k"][:, :, slot:slot + 1] = kq
        cache["v"][:, :, slot:slot + 1] = vq
        cache["k_scale"][:, :, slot:slot + 1] = ks
        cache["v_scale"][:, :, slot:slot + 1] = vs
    else:
        cache["k"][:, :, slot:slot + 1] = k
        cache["v"][:, :, slot:slot + 1] = v


def _read_cache(cache, quant: bool, heads=None):
    """This layer's cache as f32 (b, nkv, S, hd) k and v, of the kv heads
    [start, stop) ``heads`` (default all)."""
    sel = slice(None) if heads is None else slice(*heads)
    k, v = cache["k"][:, sel].float(), cache["v"][:, sel].float()
    if quant:
        return (k * cache["k_scale"][:, sel] / 127.0,
                v * cache["v_scale"][:, sel] / 127.0)
    return k, v


def _decode_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache,
                 index: int, cfg: ModelConfig, read=None,
                 q_head0: int = 0) -> torch.Tensor:
    """One token against a whole ring: ``k`` / ``v`` into slot ``index %
    S``, then q (b, nq, 1, hd), query heads [q_head0, q_head0 + nq) of the
    model, against the kv heads ``read`` of the cache (default all), each
    query head's group of them without expanding the cache (q padded with
    zero heads to whole groups where its heads start or end mid-group).
    Returns (b, nq, 1, hd)."""
    b, nq, s, hd = q.shape
    max_len = cache["k"].shape[2]
    _write_slot(cache, k, v, index % max_len, cfg.kv_quant)  # SWA: S = window
    if nq == 0:                         # a rank with no heads
        return q
    kd, vd = _read_cache(cache, cfg.kv_quant, read)
    nkv = kd.shape[1]
    rep = cfg.n_heads // cfg.n_kv_heads
    lo = q_head0 % rep
    qf = q.float()
    if lo or nq != nkv * rep:
        qf = F.pad(qf, (0, 0, 0, 0, lo, nkv * rep - nq - lo))
    qg = qf.reshape(b, nkv, rep, s, hd)
    logits = torch.einsum("bgrqd,bgkd->bgrqk", qg, kd) * (hd ** -0.5)
    # valid = filled slots only (ring: all slots < min(idx + 1, S))
    logits[..., min(index + 1, max_len):] = _NEG
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", probs, vd)
    return out.reshape(b, nkv * rep, s, hd)[:, lo:lo + nq].to(q.dtype)


def _decode_by_length(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cache, index: int, cfg: ModelConfig, length,
                      heads=None) -> torch.Tensor:
    """One token against a cache cut by length over ``length`` (module
    docstring). q: (b, nh, 1, hd), this rank's heads where the kv heads
    divide over "model" (``heads`` None), else every query head, of which
    ``heads`` [start, stop) are the rank's; k, v: the kv heads the cache
    holds, (b, nkv, 1, hd). Returns the rank's heads' (b, nq, 1, hd)."""
    b, nh, _, hd = q.shape
    s_loc, n = cache["k"].shape[2], length.size
    owner, local = divmod(index % (s_loc * n), s_loc)
    if owner == length.index:
        _write_slot(cache, k, v, local, cfg.kv_quant)
    kd, vd = _read_cache(cache, cfg.kv_quant)
    nkv = kd.shape[1]
    qg = q.float().reshape(b, nkv, nh // nkv, 1, hd)
    logits = torch.einsum("bgrqd,bgkd->bgrqk", qg, kd) * (hd ** -0.5)
    # this rank's filled slots: the ring's [0, min(index + 1, S)) in its range
    n_valid = max(0, min(s_loc, min(index + 1, s_loc * n)
                         - length.index * s_loc))
    logits[..., n_valid:] = _NEG
    m = logits.amax(-1, keepdim=True)
    probs = torch.exp(logits - m)
    probs[..., n_valid:] = 0.0          # an empty rank: weight 0, not NaN
    part = torch.cat([m, probs.sum(-1, keepdim=True),
                      torch.einsum("bgrqk,bgkd->bgrqd", probs, vd)], dim=-1)
    parts = length.all_gather(part.reshape(b, nh, hd + 2))
    if heads is not None:
        parts = parts[:, :, heads[0]:heads[1]]      # (n, b, nq, hd + 2)
    m_r, l_r, acc_r = parts[..., :1], parts[..., 1:2], parts[..., 2:]
    w = torch.exp(m_r - m_r.amax(0))
    out = (w * acc_r).sum(0) / (w * l_r).sum(0)
    return out[:, :, None].to(q.dtype)


def apply_attn(p, x: torch.Tensor, cfg: ModelConfig, *,
               window: Optional[int] = None,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               cache_index: Optional[int] = None, use_kernel: bool = True,
               model=None, length=None):
    """Full-sequence path (cache is None) or single-step decode path.

    Decode: x is (b, 1, d); cache = {"k", "v"} slabs (b, nkv, S, hd) of THIS
    layer (views into the stacked cache), written in place at slot
    ``cache_index % S``; ``cache_index`` is the host's step count, so no
    step waits on the device. ``model``: the "model" ``AxisGroup`` when
    ``p`` holds a rank's heads (module docstring); the output is then that
    rank's partial sum, in f32 (``partial_product``). ``length``: the
    group the cache is cut over by length, ``None`` for a whole ring
    (module docstring). Returns (out, cache).
    """
    b, s, _ = x.shape
    if cache is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    else:
        positions = torch.full((b, 1), cache_index, dtype=torch.int32,
                               device=x.device)
    hd = cfg.hd
    heads = share_of(cfg.n_heads, model)
    whole = kv_whole(cfg, model)
    read = None
    if whole:                           # the kv heads a rank reads (module doc)
        read = kv_read(cfg.n_heads, cfg.n_kv_heads, heads)
        every = cache is not None and length is not None
        q, k, v = _project_qkv(p, x, cfg, positions,
                               (0, cfg.n_heads) if every else heads, model,
                               read if cache is None else
                               (0, cfg.n_kv_heads))   # the cache holds all
    else:
        q, k, v = _project_qkv(p, x, cfg, positions, heads, model)
    if cache is None:
        out = _attend(q, k, v, window, use_kernel,
                      cfg.n_heads // cfg.n_kv_heads, heads[0])
    elif length is not None:
        out = _decode_by_length(q, k, v, cache, cache_index, cfg, length,
                                heads if whole else None)
    else:
        out = _decode_ring(q, k, v, cache, cache_index, cfg, read, heads[0])
    out = out.transpose(1, 2).reshape(b, s, (heads[1] - heads[0]) * hd)
    return _out_product(out, p["wo"], heads, cfg, model), cache


def _out_product(out: torch.Tensor, wo: torch.Tensor, heads,
                 cfg: ModelConfig, model) -> torch.Tensor:
    """The rank's heads' output (b, s, nq hd) through ``wo``: its part of
    the sum over "model" (``partial_product``), after the regroup to
    ``wo``'s row block (``put_share``), or on a whole ``wo``'s rows of its
    heads."""
    n, cols = cfg.n_heads * cfg.hd, (heads[0] * cfg.hd, heads[1] * cfg.hd)
    if split_axis(model) and wo.shape[0] == n:
        wo = wo[cols[0]:cols[1]]
    else:
        out = put_share(out, cols, n, model)
    return partial_product(out, wo, model)


def _attend(q, k, v, window, use_kernel: bool, group: int,
            q_head0: int) -> torch.Tensor:
    """Causal (windowed) attention of q (b, nq, s, hd), query heads
    [q_head0, q_head0 + nq) of the model, against the kv heads k / v (b,
    nkv, s, hd) they read, ``group`` query heads a kv head: the flash
    kernel, or the plain ``blockwise_attention`` on the kv heads expanded
    to the query heads. No heads: no launch; the plain path runs on the
    empty heads, so that a train step's backward reaches the kv gathers
    on every rank."""
    if use_kernel:
        if q.shape[1] == 0:
            return q
        return kops.flash_attention(q, k, v, causal=True, window=window,
                                    group=group, q_head0=q_head0)
    nq = q.shape[1]
    return blockwise_attention(q, expand_kv(k, nq, group, q_head0),
                               expand_kv(v, nq, group, q_head0), causal=True,
                               window=window)
