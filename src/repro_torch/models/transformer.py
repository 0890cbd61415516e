"""Decoder stack for the dense-attention architectures: prefill and
KV-cache decode. The twin of ``repro/models/transformer.py``.

Parameters keep the reference's layout: a plain dict whose ``groups`` entry
holds every block's leaves stacked over a leading ``n_groups`` axis, under
keys ``blk{i}_{kind}``, so ``interop.params_from_reference`` maps leaves
one to one. The reference's scan over groups is a Python loop over that
axis here. Its ``remat``, ``unroll_layers`` and ``act_specs`` do not carry
over. The full-sequence path is differentiable: ``train/step.loss_fn`` runs
it under autograd with ``use_kernel=False`` (plain attention, as the
reference trains; the flash kernel has no backward in either package).
Decoding is inference only (callers run it under
``torch.inference_mode()``).

Block kinds ``attn`` and ``swa`` with a dense SwiGLU FFN are built:
qwen2-7b, internlm2-20b, h2o-danube-1.8b and command-r-35b. MoE FFNs, the
mLSTM / sLSTM / RG-LRU blocks and the ``vlm_patches`` / ``audio_codec``
frontends raise ``NotImplementedError`` (ROADMAP queue 1: the rest of the
LM side).

Three entry points:
  * forward(params, batch, cfg)              -- training / prefill logits
  * init_decode_state(cfg, batch, max_len)   -- KV caches and step count
  * decode_step(params, state, tokens, cfg)  -- one-token serving step
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ModelConfig
from .attention import apply_attn, init_attn, init_kv_cache
from .layers import embed_lookup, init_dense, init_norm, normal, rms_norm, \
    swiglu_ffn

__all__ = ["init_params", "forward", "init_decode_state", "decode_step",
           "block_has_ffn", "embed_inputs", "tree_map", "tree_leaves"]

ATTN_KINDS = ("attn", "swa")
_TODO = ("is not ported yet (ROADMAP queue 1: the rest of the LM side; "
         "MoE, recurrent blocks and frontends wait for later slices)")


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: the MoE FFN {_TODO}")
    for kind in cfg.pattern_for_layers():
        if kind not in ATTN_KINDS:
            raise NotImplementedError(f"{cfg.name}: block kind {kind!r} "
                                      f"{_TODO}")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend!r} "
                                  f"frontend {_TODO}")


def block_has_ffn(cfg: ModelConfig, kind: str) -> bool:
    if kind in ATTN_KINDS:
        return cfg.moe is not None or cfg.d_ff > 0
    if kind == "rglru":
        return cfg.d_ff > 0
    return False  # mlstm / slstm have internal FFN-equivalents


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_block(gen: Optional[torch.Generator], cfg: ModelConfig, kind: str,
                device: torch.device) -> Dict[str, Any]:
    dt = cfg.torch_dtype
    p: Dict[str, Any] = {"norm1": init_norm(cfg.d_model, dt, device),
                         "mixer": init_attn(gen, cfg, device)}
    if block_has_ffn(cfg, kind):
        p["norm2"] = init_norm(cfg.d_model, dt, device)
        p["ffn"] = {
            "w_gate": init_dense(gen, cfg.d_model, cfg.d_ff, dt, device),
            "w_up": init_dense(gen, cfg.d_model, cfg.d_ff, dt, device),
            "w_down": init_dense(gen, cfg.d_ff, cfg.d_model, dt, device),
        }
    return p


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Weights at the reference's init scales, drawn from ``gen`` (which
    must live on ``device``; ``None`` only with ``device="meta"``).

    Each group is drawn in turn and copied into the stacked leaves, so the
    peak is the model plus one group.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    pattern = cfg.pattern_for_layers()

    def init_group():
        return {f"blk{i}_{kind}": _init_block(gen, cfg, kind, dev)
                for i, kind in enumerate(pattern)}

    first = init_group()
    groups = tree_map(lambda l: l.new_empty((cfg.n_groups,) + l.shape), first)
    for g in range(cfg.n_groups):
        block = first if g == 0 else init_group()
        for dst, src in zip(tree_leaves(groups), tree_leaves(block)):
            dst[g].copy_(src)
        del block
    del first
    params = {"embed": normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt,
                              dev),
              "groups": groups,
              "final_norm": init_norm(cfg.d_model, dt, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, cfg.d_model, cfg.vocab_size, dt,
                                       dev)
    return params


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def _ffn(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    f = p["ffn"]
    return x + swiglu_ffn(h2, f["w_gate"], f["w_up"], f["w_down"])


def _apply_block_full(p, x: torch.Tensor, cfg: ModelConfig, kind: str,
                      use_kernel: bool) -> torch.Tensor:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    out, _ = apply_attn(p["mixer"], h, cfg,
                        window=cfg.window if kind == "swa" else None,
                        use_kernel=use_kernel)
    x = x + out
    return _ffn(p, x, cfg) if block_has_ffn(cfg, kind) else x


def embed_inputs(params, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """Token embedding (the frontends' inputs wait for ROADMAP queue 1:
    the rest of the LM side)."""
    return embed_lookup(params["embed"], batch["tokens"])


def _head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    return x @ (head if head is not None else params["embed"].T)


def _group(tree, g: int):
    return tree_map(lambda l: l[g], tree)


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            use_kernel: bool = True) -> torch.Tensor:
    """Returns logits (b, s, V). ``use_kernel=False`` runs the plain
    ``blockwise_attention`` in place of the flash-attention kernel."""
    _check_supported(cfg)
    x = embed_inputs(params, batch, cfg)
    pattern = cfg.pattern_for_layers()
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        for i, kind in enumerate(pattern):
            x = _apply_block_full(gp[f"blk{i}_{kind}"], x, cfg, kind,
                                  use_kernel)
    return _head(params, x, cfg)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Per-pattern-position stacked caches + the step counter.

    The counter is a host integer: the slot and the mask of each step are
    computed on the host, so no step waits on the device.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    caches = {}
    for i, kind in enumerate(cfg.pattern_for_layers()):
        wlen = min(cfg.window or max_len, max_len) if kind == "swa" \
            else max_len
        caches[f"blk{i}_{kind}"] = init_kv_cache(cfg, batch, wlen,
                                                 cfg.n_groups, dev)
    return {"index": 0, "caches": caches}


def _apply_block_decode(p, x: torch.Tensor, cfg: ModelConfig, kind: str,
                        cache, index: int):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    out, cache = apply_attn(p["mixer"], h, cfg,
                            window=cfg.window if kind == "swa" else None,
                            cache=cache, cache_index=index)
    x = x + out
    if block_has_ffn(cfg, kind):
        x = _ffn(p, x, cfg)
    return x, cache


def decode_step(params, state: Dict[str, Any], tokens: torch.Tensor,
                cfg: ModelConfig):
    """One serving step. tokens: (b, 1).

    Returns (logits, new_state). The KV caches advance by one, written in
    place: ``new_state`` holds the same cache tensors as ``state``.
    """
    index = state["index"]
    x = embed_inputs(params, {"tokens": tokens}, cfg)
    pattern = cfg.pattern_for_layers()
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        gc = _group(state["caches"], g)
        for i, kind in enumerate(pattern):
            name = f"blk{i}_{kind}"
            x, _ = _apply_block_decode(gp[name], x, cfg, kind, gc[name],
                                       index)
    return _head(params, x, cfg), {"index": index + 1,
                                   "caches": state["caches"]}
