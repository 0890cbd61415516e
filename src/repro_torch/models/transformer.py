"""Decoder stack for every registered architecture: prefill and cached
decode. The twin of ``repro/models/transformer.py``.

Parameters keep the reference's layout: a plain dict whose ``groups`` entry
holds every block's leaves stacked over a leading ``n_groups`` axis, under
keys ``blk{i}_{kind}``, each leaf in the reference's dtype (the MoE router
and RG-LRU's ``lam`` stay f32 in a bf16 model), so
``interop.params_from_reference`` maps leaves one to one. The reference's
scan over groups is a Python loop over that axis here; its
``unroll_layers`` does not carry over. ``act_specs``
(``models/sharding.activation_specs``) is taken for its ``"moe"`` entry
only, which makes ``apply_moe`` route per data shard; its layout entries
(``act``, ``logits``, ``attn_*``) pin XLA's partitioner in the reference
and change no arithmetic here. The full-sequence
path is differentiable: ``train/step.loss_fn`` runs it under autograd with
``use_kernel=False`` (plain attention, as the reference trains; the flash
kernel has no backward in either package). Decoding is inference only
(callers run it under ``torch.inference_mode()``).

Remat (``forward(..., remat=)``, as the reference's): ``True`` runs each
group's body (one pass of the pattern) under
``torch.utils.checkpoint.checkpoint``, so backward recomputes it whole;
``"names"`` checkpoints the spans between the reference's save points
``mixer_out`` and ``ffn_out`` (a block's norm and mixer, its norm and FFN),
so what is kept is a block's input and its residual after the mixer, and
everything inside the spans (norms, projections, attention, gates, the FFN
intermediate) is recomputed; ``False`` keeps everything. The spans end before the model-axis reduce, so ``"names"``
re-runs only the collectives inside a mixer (below) and ``True`` all of
the forward's. Recomputation
never stops early (the collectives it re-runs are the same on every
rank). The values are the same bits under all three.

Split over "model" (``model=``, the "model" ``AxisGroup`` of ``launch/mesh``,
for the families ``models/sharding.model_view`` admits: the attention families,
recurrentgemma's RG-LRU and windowed attention, xLSTM's mLSTM and sLSTM, the
VLM and audio frontends, with heads that do not divide over "model" shared
out whole): ``params`` hold a rank's model blocks (each leaf
gathered over the data axes only). The embedding's block of the model dim,
laid out (V, pieces, D / (pieces tp)) (audio: (K, V, pieces, c); its spec
cuts the dim over (data, model)), is looked up (audio: its K lookups summed
on the rank's pieces) and the activations gathered once over "model", then
the VLM's patch embeddings spliced in; each norm's output enters the
column-parallel span through ``copy_to_model``; the mixer's and the FFN's
partial outputs are summed by ``reduce_from_model``; the head gives this rank's
block of its columns (vocabulary rows; audio: (codebook, vocabulary) columns,
codebook-major), a tied head from the rank's vocabulary rows of the
embedding (``_tied_logits``). A mixer whose channels do not divide over
"model" (RG-LRU, sLSTM: ``sharding.whole_mixers``) runs whole on every rank,
on the norm's output and its whole leaves (``_whole_leaves``), and its output
is added as it is, with no collective either way. Where the embedding's model
dim does not divide over its axes the table is whole on every rank and
looked up whole. Each row-parallel product is an f32 part
(``partial_product``), summed in f32 and rounded once to the model's dtype, as
one process rounds the whole product. The mixers split themselves
(``attention.py``, ``recurrent.py``), some with collectives inside the
``"names"`` span (gathers of a recurrent state or a kv head, mLSTM's gate sum),
which its recomputation runs again. ``None`` (or a one-rank axis) keeps the
unsplit arithmetic bit for bit.

Block kinds: ``attn`` / ``swa`` (through the flash-attention kernel) with a
dense SwiGLU FFN or, when ``cfg.moe`` is set, the MoE FFN
(``models/moe.py``); ``rglru`` with a dense FFN when ``d_ff > 0``;
``mlstm`` / ``slstm`` with none (``models/recurrent.py``). Frontends:
``audio_codec`` sums K codebook embeddings of (b, s, K) tokens and emits
(b, s, K, V) logits; ``vlm_patches`` splices the batch's ``patch_embeds``
over the first ``n_prefix_tokens`` positions.

Three entry points:
  * forward(params, batch, cfg)              -- training / prefill logits
  * init_decode_state(cfg, batch, max_len)   -- caches, states, step count
  * decode_step(params, state, tokens, cfg)  -- one-token serving step
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from .._device import DeviceLike, resolve_device
from ..configs.base import ModelConfig
from ..launch.mesh import (copy_to_model, gather_from_model,
                           partial_product, reduce_from_model,
                           rows_from_model, scatter_summed_to_model,
                           slice_to_model, split_axis)
from .attention import apply_attn, init_attn, init_kv_cache, kv_whole
from .layers import embed_lookup, init_dense, init_norm, normal, rms_norm, \
    swiglu_ffn
from .moe import apply_moe, init_moe
from .recurrent import (apply_mlstm, apply_rglru, apply_slstm, init_mlstm,
                        init_mlstm_state, init_rglru, init_rglru_state,
                        init_slstm, init_slstm_state)
from .sharding import refuse_tied_audio, whole_mixers

__all__ = ["init_params", "forward", "init_decode_state", "decode_step",
           "block_has_ffn", "embed_inputs", "tree_map", "tree_leaves",
           "REMAT_MODES"]

ATTN_KINDS = ("attn", "swa")
REMAT_MODES = (False, True, "names")
_MIXERS = {"mlstm": (init_mlstm, apply_mlstm, init_mlstm_state),
           "slstm": (init_slstm, apply_slstm, init_slstm_state),
           "rglru": (init_rglru, apply_rglru, init_rglru_state)}


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def block_has_ffn(cfg: ModelConfig, kind: str) -> bool:
    if kind in ATTN_KINDS:
        return cfg.moe is not None or cfg.d_ff > 0
    if kind == "rglru":
        return cfg.d_ff > 0
    return False  # mlstm / slstm have internal FFN-equivalents


def _is_moe(cfg: ModelConfig, kind: str) -> bool:
    return cfg.moe is not None and kind in ATTN_KINDS


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_block(gen: Optional[torch.Generator], cfg: ModelConfig, kind: str,
                device: torch.device) -> Dict[str, Any]:
    dt = cfg.torch_dtype
    if kind in ATTN_KINDS:
        mixer = init_attn(gen, cfg, device)
    elif kind in _MIXERS:
        mixer = _MIXERS[kind][0](gen, cfg, device)
    else:
        raise ValueError(f"unknown block kind {kind}")
    p: Dict[str, Any] = {"norm1": init_norm(cfg.d_model, dt, device),
                         "mixer": mixer}
    if block_has_ffn(cfg, kind):
        p["norm2"] = init_norm(cfg.d_model, dt, device)
        if _is_moe(cfg, kind):
            p["ffn"] = init_moe(gen, cfg, device)
        else:
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
    peak is the model plus one group; a single group is not copied at all
    (kimi-k2 cut to one layer holds 39 GB).
    """
    refuse_tied_audio(cfg)
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    pattern = cfg.pattern_for_layers()

    def init_group():
        return {f"blk{i}_{kind}": _init_block(gen, cfg, kind, dev)
                for i, kind in enumerate(pattern)}

    first = init_group()
    if cfg.n_groups == 1:
        groups = tree_map(lambda l: l[None], first)
    else:
        groups = tree_map(lambda l: l.new_empty((cfg.n_groups,) + l.shape),
                          first)
        for g in range(cfg.n_groups):
            block = first if g == 0 else init_group()
            for dst, src in zip(tree_leaves(groups), tree_leaves(block)):
                dst[g].copy_(src)
            del block
    del first
    if cfg.frontend == "audio_codec":
        embed = normal(gen, (cfg.n_codebooks, cfg.vocab_size, cfg.d_model),
                       0.02, dt, dev)
        head = init_dense(gen, cfg.d_model, cfg.n_codebooks * cfg.vocab_size,
                          dt, dev)
    else:
        embed = normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt, dev)
        head = None if cfg.tie_embeddings else init_dense(
            gen, cfg.d_model, cfg.vocab_size, dt, dev)
    params = {"embed": embed, "groups": groups,
              "final_norm": init_norm(cfg.d_model, dt, dev)}
    if head is not None:
        params["lm_head"] = head
    return params


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def _recompute(fn, *args):
    """``fn(*args)`` under non-reentrant checkpointing, recomputed whole in
    backward (no early stop: its collectives run again on every rank)."""
    with torch_checkpoint.set_checkpoint_early_stop(False):
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                           preserve_rng_state=False)


def _call(fn, *args):
    return fn(*args)


def _whole(cfg: ModelConfig, kind: str, model) -> bool:
    """Whether every rank of a split computes ``kind``'s mixer whole
    (``sharding.whole_mixers``)."""
    return split_axis(model) and kind in whole_mixers(cfg, model.size)


def _whole_leaves(p, cfg: ModelConfig, kind: str, model):
    """A whole mixer's leaves, each whole: a leaf ``param_specs`` cuts over
    "model" anyway (sLSTM's 4 d gate columns, its FFN's where they divide)
    gathered along the dim it is cut on, its gradient this rank's slice
    (``gather_from_model``: every rank's consumer is the same)."""
    like = _MIXERS[kind][0](None, cfg, torch.device("meta"))
    out = {}
    for k, w in p.items():
        cut = [i for i, (a, b) in enumerate(zip(w.shape, like[k].shape))
               if a != b]
        out[k] = gather_from_model(w, model, cut[0]) if cut else w
    return out


def _mixer(p, x: torch.Tensor, cfg: ModelConfig, kind: str,
           use_kernel: bool, model) -> torch.Tensor:
    """Norm and mixer: the span before the save point ``mixer_out`` (a
    rank's partial sum when split; the whole output where the rank
    computes the mixer whole, ``_whole``)."""
    if _whole(cfg, kind, model):
        out, _ = _MIXERS[kind][1](_whole_leaves(p["mixer"], cfg, kind, model),
                                  rms_norm(x, p["norm1"], cfg.norm_eps), cfg)
        return out
    h = copy_to_model(rms_norm(x, p["norm1"], cfg.norm_eps), model)
    if kind in ATTN_KINDS:
        out, _ = apply_attn(p["mixer"], h, cfg,
                            window=cfg.window if kind == "swa" else None,
                            use_kernel=use_kernel, model=model)
    else:
        out, _ = _MIXERS[kind][1](p["mixer"], h, cfg, model=model)
    return out


def _ffn(p, x: torch.Tensor, cfg: ModelConfig, kind: str, act_specs,
         model) -> torch.Tensor:
    """Norm and FFN: the span before ``ffn_out`` (partial when split)."""
    h2 = copy_to_model(rms_norm(x, p["norm2"], cfg.norm_eps), model)
    f = p["ffn"]
    if _is_moe(cfg, kind):
        return apply_moe(f, h2, cfg, act_specs=act_specs, model=model)
    if not split_axis(model):
        return swiglu_ffn(h2, f["w_gate"], f["w_up"], f["w_down"])
    return partial_product(F.silu(h2 @ f["w_gate"]) * (h2 @ f["w_up"]),
                           f["w_down"], model)


def _apply_block_full(p, x: torch.Tensor, cfg: ModelConfig, kind: str,
                      use_kernel: bool, act_specs=None, model=None,
                      span=_call) -> torch.Tensor:
    """One block; ``span`` runs the mixer's and the FFN's spans
    (``_recompute`` under ``remat="names"``)."""
    x = x + reduce_from_model(
        span(_mixer, p, x, cfg, kind, use_kernel, model),
        None if _whole(cfg, kind, model) else model).to(x.dtype)
    if block_has_ffn(cfg, kind):
        x = x + reduce_from_model(
            span(_ffn, p, x, cfg, kind, act_specs, model), model).to(x.dtype)
    return x


def embed_inputs(params, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, model=None) -> torch.Tensor:
    """Token embedding with the modality frontends. Their encoders are
    stubs, as in the reference: ``audio_codec`` tokens arrive as (b, s, K)
    codebook ids and their K embeddings are summed; ``vlm_patches`` takes
    precomputed image-patch embeddings from ``batch["patch_embeds"]`` and
    splices them over the first ``n_prefix_tokens`` positions.
    ``inputs_embeds`` skips the lookup. ``model``: the embedding is this
    rank's (V, pieces, c) block, audio's (K, V, pieces, c) (module
    docstring); the looked-up pieces (audio: their sum over the K
    codebooks, which is linear, so one gather carries it) are gathered over
    "model" into (b, s, D), and the patches spliced in after. A table
    whole on every rank ((V, D), audio's (K, V, D): the model dim does not
    divide over its axes) is looked up whole."""
    if "inputs_embeds" in batch:
        return batch["inputs_embeds"]
    tokens, emb = batch["tokens"], params["embed"]
    split = split_axis(model) and emb.dim() == (
        4 if cfg.frontend == "audio_codec" else 3)

    def lookup(table, ids):         # a rank's pieces: (V, pieces x c)
        return embed_lookup(table.flatten(-2) if split else table, ids)

    if cfg.frontend == "audio_codec":
        x = sum(lookup(emb[k], tokens[..., k])
                for k in range(cfg.n_codebooks))
    else:
        x = lookup(emb, tokens)
    if split:
        x = gather_from_model(x.unflatten(-1, emb.shape[-2:]), model,
                              dim=-1).flatten(-2)
    if cfg.frontend == "vlm_patches" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, cfg.n_prefix_tokens:]], dim=1)
    return x


def _tied_logits(x: torch.Tensor, emb: torch.Tensor, model,
                 exchange: bool) -> torch.Tensor:
    """This rank's (b, s, V / tp) block of a tied head's logits, x @ E^T
    for its vocabulary rows E[V_m]. The stored embedding cuts the model
    dim, so a rank holds a (V, pieces, c) column block of every row. Two
    routes: ``exchange`` (train and prefill) turns it into the rank's
    whole rows by one all-to-all (``rows_from_model``: V D / tp elements a
    rank, whatever the batch; the gradient goes back the same way into the
    rank's block, summed there with the lookup's); else (decode) each rank
    multiplies its columns of x by its block, an f32 part of every
    vocabulary row, and a reduce-scatter sums the parts to the rank's rows
    (b s V f32 a rank: small for a few tokens), rounded once. A table whole
    on every rank is sliced to its rows (``slice_to_model``: its gradient
    gathered whole)."""
    if emb.dim() == 2:
        return x @ slice_to_model(emb, model, 0).T
    if exchange:
        return x @ rows_from_model(emb, model).T
    pieces, c = emb.shape[1:]
    cols = x.unflatten(-1, (pieces, model.size, c))[..., model.index, :]
    part = partial_product(cols.flatten(-2), emb.flatten(-2).T, model)
    return scatter_summed_to_model(part, model, -1).to(x.dtype)


def _head(params, x: torch.Tensor, cfg: ModelConfig, *,
          model=None, exchange: bool = True) -> torch.Tensor:
    """Final norm and logits: (b, s, V), or (b, s, K, V) for audio; split
    over ``model``, this rank's block of the head's columns: vocabulary
    rows (b, s, V / tp); audio's K V columns are codebook-major, so (b, s,
    K / tp, V) where tp divides K, else (b, s, K V / tp) (a codebook cut
    mid-vocabulary). A tied head (no ``lm_head``) multiplies by the
    embedding's transpose; split, by ``_tied_logits``' route (``exchange``:
    forward's; decode's the other)."""
    x = copy_to_model(rms_norm(x, params["final_norm"], cfg.norm_eps), model)
    head = params.get("lm_head")
    if head is not None:
        logits = x @ head
    elif split_axis(model):
        logits = _tied_logits(x, params["embed"], model, exchange)
    else:
        logits = x @ params["embed"].T
    if cfg.frontend == "audio_codec":
        b, s, _ = x.shape
        k = cfg.n_codebooks
        if split_axis(model):
            if k % model.size:
                return logits
            k //= model.size
        logits = logits.reshape(b, s, k, cfg.vocab_size)
    return logits


def _group(tree, g: int):
    return tree_map(lambda l: l[g], tree)


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            use_kernel: bool = True, act_specs=None, remat=False,
            model=None) -> torch.Tensor:
    """Returns logits (b, s, V) (audio: (b, s, K, V)). ``use_kernel=False``
    runs the plain ``blockwise_attention`` in place of the flash-attention
    kernel. ``act_specs``: see the module docstring (only ``"moe"``
    acts). ``remat``: ``False`` (prefill), ``True`` or ``"names"`` (module
    docstring; it acts only under autograd). ``model``: the "model" axis
    of a split (module docstring)."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat={remat!r}: one of {REMAT_MODES}")
    span = _recompute if remat == "names" else _call
    x = embed_inputs(params, batch, cfg, model=model)
    pattern = cfg.pattern_for_layers()
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)

        def body(x, gp=gp):
            for i, kind in enumerate(pattern):
                x = _apply_block_full(gp[f"blk{i}_{kind}"], x, cfg, kind,
                                      use_kernel, act_specs, model, span)
            return x

        x = _recompute(body, x) if remat is True else body(x)
    return _head(params, x, cfg, model=model)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _length_group(cfg: ModelConfig, model, length):
    """``length``, or by default "model" where the kv heads do not divide
    over it (``sharding.length_axes`` of a batch that divides)."""
    if length is None and kv_whole(cfg, model):
        return model
    return length if split_axis(length) else None


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: DeviceLike = None, model=None,
                      length=None) -> Dict[str, Any]:
    """Per-pattern-position stacked caches and states + the step counter.

    Attention blocks get a ring-buffer KV cache (``swa``: of the window),
    recurrent ones their f32 state. The counter is a host integer: the slot
    and the mask of each step are computed on the host, so no step waits on
    the device. ``model``: a model rank's share, as ``decode_state_specs``
    cuts it: n_kv_heads / tp kv heads where they divide, else every kv
    head; RG-LRU's and sLSTM's channels, d / tp of them (a block that may
    end mid-head), mLSTM's heads, h / tp of them where they divide, else
    every one.
    ``length``: the group (``sharding.length_axes``; default "model" where
    the kv heads do not divide over it) whose n ranks each hold S / n ring
    slots; a ring that does not divide over it is whole on every rank, as
    the reference keeps it. ``batch`` is the rank's rows. A split state
    (``model`` or ``length`` given) also holds ``rings``: each attention
    block's whole ring length, host integers.
    """
    dev = resolve_device(device)
    tp = model.size if split_axis(model) else 1
    group = _length_group(cfg, model, length)
    n = group.size if group is not None else 1
    nkv = cfg.n_kv_heads if kv_whole(cfg, model) else cfg.n_kv_heads // tp
    caches, rings = {}, {}
    for i, kind in enumerate(cfg.pattern_for_layers()):
        name = f"blk{i}_{kind}"
        if kind in ATTN_KINDS:
            wlen = min(cfg.window or max_len, max_len) if kind == "swa" \
                else max_len
            rings[name] = wlen
            caches[name] = init_kv_cache(
                cfg, batch, wlen // n if wlen % n == 0 else wlen,
                cfg.n_groups, dev, n_kv_heads=nkv)
        else:
            caches[name] = _MIXERS[kind][2](cfg, batch, cfg.n_groups, dev,
                                            tp=tp)
    state = {"index": 0, "caches": caches}
    if split_axis(model) or split_axis(length):
        state["rings"] = rings
    return state


def _apply_block_decode(p, x: torch.Tensor, cfg: ModelConfig, kind: str,
                        cache, index: int, act_specs=None, model=None,
                        length=None) -> torch.Tensor:
    """One token through one block; ``cache`` (this layer's views into the
    stacked caches) is written in place; ``length``: the group its ring is
    cut over, ``None`` for a whole one."""
    h = copy_to_model(rms_norm(x, p["norm1"], cfg.norm_eps), model)
    if kind in ATTN_KINDS:
        out, _ = apply_attn(p["mixer"], h, cfg,
                            window=cfg.window if kind == "swa" else None,
                            cache=cache, cache_index=index, model=model,
                            length=length)
    else:
        whole = _whole(cfg, kind, model)
        out, new_state = _MIXERS[kind][1](
            _whole_leaves(p["mixer"], cfg, kind, model) if whole
            else p["mixer"], h, cfg, state=cache,
            model=None if whole else model)
        for key, val in new_state.items():
            cache[key].copy_(val)
    x = x + reduce_from_model(
        out, None if _whole(cfg, kind, model) else model).to(x.dtype)
    if block_has_ffn(cfg, kind):
        x = x + reduce_from_model(_ffn(p, x, cfg, kind, act_specs, model),
                                  model).to(x.dtype)
    return x


def decode_step(params, state: Dict[str, Any], tokens: torch.Tensor,
                cfg: ModelConfig, *, act_specs=None, model=None,
                length=None):
    """One serving step. tokens: (b, 1) (audio: (b, 1, K)). ``act_specs``
    and ``model`` as in ``forward`` (split: ``state`` from
    ``init_decode_state(..., model=, length=)`` with the same groups, the
    logits this rank's block of the head's columns).

    Returns (logits, new_state). The caches and states advance by one,
    written in place: ``new_state`` holds the same tensors as ``state``.
    """
    index = state["index"]
    group = _length_group(cfg, model, length)
    rings = state.get("rings", {})
    x = embed_inputs(params, {"tokens": tokens}, cfg, model=model)
    pattern = cfg.pattern_for_layers()
    for g in range(cfg.n_groups):
        gp = _group(params["groups"], g)
        gc = _group(state["caches"], g)
        for i, kind in enumerate(pattern):
            name = f"blk{i}_{kind}"
            cut = name in rings and gc[name]["k"].shape[2] < rings[name]
            x = _apply_block_decode(gp[name], x, cfg, kind, gc[name], index,
                                    act_specs, model,
                                    group if cut else None)
    return _head(params, x, cfg, model=model, exchange=False), {
        "index": index + 1, "caches": state["caches"],
        **({"rings": rings} if "rings" in state else {})}
