"""Analytic per-step FLOP / HBM-byte model for every (arch x shape) cell.
The twin of ``repro/launch/analytic_cost.py``: plain Python over the port's
configs and ``models/recurrent.py``, giving the reference's numbers.

It walks the block structure of models/transformer.py and counts:

  * FLOPs: 2mnk per matmul (fwd), x3 for backward (dgrad+wgrad), +1 fwd for
    full remat; attention scores/av; recurrences.
  * HBM bytes: weights traffic (streamed once per pass), activations r/w,
    optimizer state update traffic, KV/state cache traffic for decode.

A train step follows its ``remat``: ``True`` (the reference's model, the
default) counts 4x the forward's FLOPs and three weight reads, ``False``
3x and two. ``"names"`` counts as ``True``: it keeps only the mixer's and
the FFN's outputs, so the backward recomputes the projections, the
attention and the FFN's GEMMs inside them as well as the elementwise work
(the reference's ``save_only_these_names`` policy recomputes them too).

All numbers are GLOBAL per step. ``chip_smoke.py`` divides a prefill's
FLOPs by its wall time and the H100's bf16 peak.
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig, ShapeConfig
from ..models.recurrent import _mlstm_hd, _slstm_hd, mlstm_heads

__all__ = ["analytic_cost", "straggler_slowdown"]


def straggler_slowdown(*, n_nodes: int, t_step: float, delay: float,
                       synchronous: bool = True) -> float:
    """Expected wall time of one outer iteration with one random straggler.

    The paper's Table V setting: a bulk-synchronous network where every
    iteration one randomly-chosen node sleeps ``delay`` seconds. Synchronous
    gossip blocks on the slowest rank, so the whole network pays the delay
    every iteration; an asynchronous network would amortize it (each node is
    the straggler only 1/N of the time).
    """
    if synchronous:
        return t_step + delay
    return t_step + delay / n_nodes


def _attn_block_flops(cfg: ModelConfig, t: int, s_ctx: int, window, decode: bool):
    """Forward FLOPs of one attention block on t tokens with context s_ctx."""
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    proj = 2 * t * d * (nq * hd) + 2 * 2 * t * d * (nkv * hd) + 2 * t * (nq * hd) * d
    ctx = min(window, s_ctx) if window else s_ctx
    if decode:
        att = 2 * t * nq * hd * ctx * 2          # qk + av over the cache
    else:
        # causal: each token attends to ~min(pos, window) keys; average ctx/2
        # (full) or ~window (swa, once past the window)
        if window and s_ctx > window:
            avg = window
        else:
            avg = ctx / 2
        att = 2 * t * nq * hd * avg * 2
    return proj + att


def _ffn_flops(cfg: ModelConfig, t: int):
    if cfg.moe is not None:
        m = cfg.moe
        act = 3 * 2 * t * cfg.d_model * m.d_expert * (m.top_k + m.n_shared_experts)
        router = 2 * t * cfg.d_model * m.n_experts
        return act + router
    if cfg.d_ff > 0:
        return 3 * 2 * t * cfg.d_model * cfg.d_ff
    return 0


def _mlstm_flops(cfg: ModelConfig, t: int, decode: bool):
    d = cfg.d_model
    up = 2 * d
    h, hd = mlstm_heads(cfg), _mlstm_hd(cfg)
    proj = 2 * t * d * up * 2 + 2 * t * up * d      # up, gate, down
    qkv = 3 * 2 * t * h * hd * hd                    # block-diag per head
    if decode:
        state = t * h * hd * hd * 4                  # kv outer + q.C
    else:
        L = min(cfg.mlstm_chunk, t)
        # intra-chunk quadratic + state update per chunk
        state = 2 * t * h * hd * L * 2 + 2 * t * h * hd * hd * 2
    return proj + qkv + state


def _slstm_flops(cfg: ModelConfig, t: int):
    d = cfg.d_model
    hd = _slstm_hd(d)
    f_up = 4 * d // 3
    gates = 2 * t * d * 4 * d + 2 * t * d * 4 * hd   # input + block-diag recur
    ffn = 2 * t * d * 2 * f_up + 2 * t * f_up * d
    return gates + ffn + 20 * t * d                  # elementwise cell


def _rglru_flops(cfg: ModelConfig, t: int):
    d = cfg.d_model
    proj = 2 * t * d * d * 4                         # in, gate_in, rgate+igate
    out = 2 * t * d * d
    conv = 8 * t * d
    scan = 12 * t * d
    return proj + out + conv + scan


def _head_embed_flops(cfg: ModelConfig, t: int):
    v = cfg.vocab_size * (cfg.n_codebooks if cfg.frontend == "audio_codec" else 1)
    return 2 * t * cfg.d_model * v                   # lm head (embed is gather)


def analytic_cost(cfg: ModelConfig, shape: ShapeConfig, *,
                  remat=True) -> Dict[str, float]:
    kind = shape.kind
    decode = kind == "decode"
    t = shape.global_batch if decode else shape.tokens
    s_ctx = shape.seq_len

    per_layer = 0.0
    for blk in cfg.pattern_for_layers():
        if blk in ("attn", "swa"):
            w = cfg.window if blk == "swa" else None
            per_layer += _attn_block_flops(cfg, t, s_ctx, w, decode)
            per_layer += _ffn_flops(cfg, t)
        elif blk == "mlstm":
            per_layer += _mlstm_flops(cfg, t, decode)
        elif blk == "slstm":
            per_layer += _slstm_flops(cfg, t)
        elif blk == "rglru":
            per_layer += _rglru_flops(cfg, t)
            if cfg.d_ff > 0:
                per_layer += _ffn_flops(cfg, t)
    fwd = per_layer * cfg.n_groups + _head_embed_flops(cfg, t)

    passes = 2.0 if remat is False else 3.0  # fwd, bwd (+ fwd remat)
    if kind == "train":
        flops = fwd * (passes + 1.0)     # bwd = 2x fwd
    else:
        flops = fwd

    # ---- HBM bytes (global) ----
    pbytes = cfg.torch_dtype.itemsize
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    d = cfg.d_model
    act_unit = t * d * pbytes            # one activation tensor
    n_blocks = cfg.n_layers
    if kind == "train":
        # weights: fwd + bwd + remat reads, wgrad writes; adam: read m,v,p,g
        # write m,v,p (fp32 moments => x2 factor on moment traffic)
        wbytes = n_params * pbytes * passes + n_params * 4 * 6
        abytes = act_unit * n_blocks * 8         # saved + recomputed + grads
        cbytes = 0.0
    elif kind == "prefill":
        wbytes = n_params * pbytes
        abytes = act_unit * n_blocks * 4
        cbytes = 0.0
    else:
        wbytes = n_active * pbytes               # every weight read once
        abytes = act_unit * n_blocks * 4
        cbytes = _cache_bytes(cfg, shape)
    return {
        "flops": float(flops),
        "hbm_bytes": float(wbytes + abytes + cbytes),
        "weight_bytes": float(wbytes),
        "cache_bytes": float(cbytes),
    }


def _cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Decode: KV/state cache read+write traffic per step (global)."""
    b = shape.global_batch
    total = 0.0
    pb = cfg.torch_dtype.itemsize
    for blk in cfg.pattern_for_layers():
        if blk == "attn":
            total += 2 * b * cfg.n_kv_heads * cfg.hd * shape.seq_len * pb  # read K,V
        elif blk == "swa":
            w = min(cfg.window or shape.seq_len, shape.seq_len)
            total += 2 * b * cfg.n_kv_heads * cfg.hd * w * pb
        elif blk == "mlstm":
            h, hd = mlstm_heads(cfg), _mlstm_hd(cfg)
            total += 2 * b * h * hd * hd * 4                    # read+write C
        elif blk == "slstm":
            total += 6 * b * cfg.d_model * 4
        elif blk == "rglru":
            total += 2 * b * cfg.d_model * 4
    return total * cfg.n_groups
