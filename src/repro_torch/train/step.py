"""Train and serve steps: the twin of ``repro/train/step.py``.

``make_train_step``      one rank's step: loss, autograd, AdamW.
``make_psa_train_step``  the paper-integrated step: each pod is one rank of
                         the pod axis (an ``AxisGroup``), and the cross-pod
                         gradient reduction goes through PSA subspace
                         compression (optim/psa_compress.py), whose
                         projector S-DOT keeps over the pod ring.
``make_sharded_train_step``  one rank of a (pod?, data, model) mesh that
                         stores only its blocks of the parameters and AdamW
                         moments (models/sharding.py's rules) and keeps its
                         own block of the update. ``split_model=True``
                         splits the compute over "model" (tensor
                         parallelism: the attention families,
                         recurrentgemma, xLSTM and the VLM and audio
                         frontends, heads that do not divide over
                         "model" shared out whole): it gathers over the
                         data axes only. ``split_model=False``
                         gathers each leaf whole and repeats the model on
                         every rank of a data shard: the plain route the
                         split is held against, and the route of the
                         families the split does not cover.
``make_sharded_serve_step``  (prefill, decode) over the same mesh, split
                         over "model": the twin of the programs the
                         reference's dry run lowers;
                         ``sharded_decode_state`` a rank's decode state.
``make_serve_step``      one-token decode with the KV caches.

The reference trains through plain attention (``use_pallas=False``): the
flash kernel has no backward in either package, so ``loss_fn`` runs
``forward(..., use_kernel=False)``. Every train step takes the reference's
``remat`` (default ``True``; ``models/transformer.py``); the values are the
same bits under each.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist

from .. import _tree
from ..configs.base import ModelConfig, PSAConfig
from ..launch.mesh import reduce_from_model, split_axis
from ..models import sharding as shd
from ..models.transformer import (decode_step, forward, init_decode_state,
                                  init_params, tree_map)
from ..optim.adamw import AdamWConfig, adamw_update, global_norm, \
    sum_squares
from ..optim.psa_compress import compress_grads, group_mean, psa_refresh

__all__ = ["loss_fn", "make_train_step", "make_psa_train_step",
           "make_sharded_train_step", "make_sharded_value_and_grad",
           "make_sharded_serve_step", "sharded_decode_state",
           "make_serve_step", "shard_batch"]


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            act_specs=None, remat=True, model=None) -> torch.Tensor:
    """Mean next-token cross entropy from float32 logits. The gold logit is
    read by index: the reference's masked sum over the vocabulary adds one
    logit to zeros, the same value. ``act_specs`` as ``forward`` takes it
    (only its ``"moe"`` entry acts); ``remat`` as ``forward``'s.

    ``model``: the "model" axis of a split (``forward``'s), whose logits
    are each rank's block of the head's columns: a vocabulary-parallel
    cross entropy in f32, a codebook at a time for audio (its K V columns
    codebook-major, so a rank may hold parts of several codebooks, or of
    one cut mid-vocabulary). Each codebook's max and sum of exponentials
    over the rank's columns of it (-inf and 0 where it holds none) are
    reduced over "model" as (b, s, K) (the max outside autograd: the
    log-sum-exp's gradient does not depend on it), and the gold logit,
    column k V + label, comes from the rank that holds it, zeros from the
    others, summed."""
    logits = forward(params, batch, cfg, use_kernel=False,
                     act_specs=act_specs, remat=remat,
                     model=model).to(torch.float32)
    labels = batch["labels"].long()
    if not split_axis(model):
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None])[..., 0]
        return torch.mean(logz - gold)
    cols = logits.flatten(2)                    # (b, s, n) of K V columns
    n, v = cols.shape[-1], cfg.vocab_size
    n_k = cfg.n_codebooks if cfg.frontend == "audio_codec" else 1
    c0 = model.index * n
    spans = [(max(c0, k * v) - c0, min(c0 + n, (k + 1) * v) - c0)
             for k in range(n_k)]
    with torch.no_grad():
        top = torch.stack([cols[..., lo:hi].amax(-1) if lo < hi else
                           cols.new_full(cols.shape[:2], -math.inf)
                           for lo, hi in spans], -1)
    top = model.all_reduce_(top, op=dist.ReduceOp.MAX)
    sumexp = reduce_from_model(torch.stack([
        torch.exp(cols[..., lo:hi] - top[..., k, None]).sum(-1) if lo < hi
        else cols.new_zeros(cols.shape[:2])
        for k, (lo, hi) in enumerate(spans)], -1), model)
    local = labels.reshape(top.shape) + torch.arange(
        n_k, device=labels.device) * v - c0
    mine = (local >= 0) & (local < n)
    gold = cols.gather(-1, local.clamp(0, n - 1))
    gold = reduce_from_model(torch.where(mine, gold, 0.0), model)
    return torch.mean(torch.log(sumexp) + top - gold)


def _value_and_grad(params, batch, cfg: ModelConfig, **loss_kw):
    """(loss, grads): one backward pass, grads in the parameters' dtypes
    and tree. ``loss_kw``: ``loss_fn``'s keywords."""
    _, leaves, structure = _tree.flatten_with_names(params)
    live = [leaf.detach().requires_grad_() for leaf in leaves]
    with torch.enable_grad():
        loss = loss_fn(_tree.unflatten(structure, live), batch, cfg,
                       **loss_kw)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), _tree.unflatten(structure, list(grads))


def shard_batch(batch: Dict[str, torch.Tensor], index: int,
                count: int) -> Dict[str, torch.Tensor]:
    """Shard ``index`` of ``count`` of a global batch: contiguous rows, as
    the reference shards the batch axis over its pods."""
    rows = batch["labels"].shape[0]
    if rows % count:
        raise ValueError(f"a batch of {rows} does not split over {count}")
    per = rows // count
    return {k: v[index * per:(index + 1) * per] for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *, group=None,
                    donate: bool = True, remat=True):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``group``: a data-parallel axis (``AxisGroup``) whose ranks each take a
    shard of the batch: the gradient and the loss are their f32 means, as
    the reference's XLA all-reduce over its data axes. ``None``: one rank.
    ``donate``: AdamW writes into the given parameters and moments.
    ``remat``: ``forward``'s."""

    def step(params, opt_state, batch):
        loss, grads = _value_and_grad(params, batch, cfg, remat=remat)
        if group is not None:
            grads = tree_map(
                lambda g: group_mean(g, group, donate=donate), grads)
            loss = group.all_reduce_(loss.reshape(1))[0] / group.size
        new_params, new_opt, gnorm = adamw_update(grads, opt_state, params,
                                                  opt, donate=donate)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return step


def make_psa_train_step(cfg: ModelConfig, opt: AdamWConfig, psa: PSAConfig,
                        *, group, donate: bool = True, remat=True):
    """(step, refresh) with PSA-compressed cross-pod gradient reduction.

    ``group``: the pod axis (``launch/mesh.AxisGroup``); this rank is one
    pod. Both callables take this pod's shard of the global batch
    (``shard_batch``). ``step(params, opt_state, psa_state, batch)`` ->
    (params, opt_state, psa_state, metrics): the pod's gradients, reduced
    across pods as the projected U = P^T G (plus the uncompressed small
    leaves, f32 all-reduces over the pods), error feedback, AdamW; the loss
    is the pod mean. ``refresh(params, psa_state, batch)`` -> psa_state: one
    S-DOT subspace update from the pod's gradients, gossiping over the pod
    ring.

    The reference computes the embedding gather, and its scatter VJP,
    outside its manual-pod region: a workaround for XLA's partitioner. Here
    one backward pass gives the pod's whole gradient, the embedding's
    included, and the embedding's gradient (excluded from compression by
    name) is reduced as a dense f32 pod mean. With ``tie_embeddings`` the
    same holds: the head's contribution is in the same leaf. ``remat``:
    ``forward``'s.
    """
    if group is None or group.size < 2:
        raise ValueError("PSA train step needs a pod axis of >= 2 pods")
    npods = group.size

    def step(params, opt_state, psa_state, batch):
        loss, grads = _value_and_grad(params, batch, cfg, remat=remat)
        red, new_ef = compress_grads(grads, psa_state, psa, pod_axis=group,
                                     donate=donate)
        del grads
        loss = group.all_reduce_(loss.reshape(1))[0] / npods     # pmean
        new_params, new_opt, gnorm = adamw_update(red, opt_state, params,
                                                  opt, donate=donate)
        new_psa = {"proj": psa_state["proj"], "ef": new_ef}
        return new_params, new_opt, new_psa, {"loss": loss,
                                              "grad_norm": gnorm}

    def refresh(params, psa_state, batch):
        _, grads = _value_and_grad(params, batch, cfg, remat=remat)
        return psa_refresh(grads, psa_state, psa, pod_axis=group)

    return step, refresh


def _model_blocks(params, specs, mesh, view: shd.ModelView):
    """A rank's stored blocks gathered over the data axes only
    (``sharding.data_specs``): its model blocks, the embedding's model dim
    laid out (pieces, c) for ``forward(..., model=)`` where it is cut over
    "model" (else the table is whole)."""
    local = shd.gather_tree(params, shd.data_specs(specs, mesh), mesh)
    if view.embed_cut:
        local["embed"] = local["embed"].unflatten(
            -1, (view.embed_pieces, -1))
    return local


def _split_norm(grads, specs, model) -> torch.Tensor:
    """The global norm of a gradient whose leaves cut over "model" are a
    rank's blocks and the rest whole on every rank: each element counted
    once (the blocks' f32 sum of squares summed over "model")."""
    leaves = _tree.tree_leaves(grads)
    cut = [shd.has_model(s) for s in shd.spec_leaves(specs)]
    part = sum_squares([g for g, c in zip(leaves, cut) if c]).reshape(1)
    rest = sum_squares([g for g, c in zip(leaves, cut) if not c])
    return torch.sqrt(model.all_reduce_(part)[0] + rest)


def make_sharded_value_and_grad(cfg: ModelConfig, mesh, *,
                                global_batch: int, remat=True,
                                split_model: bool = False):
    """(params, batch) -> (loss, grads, grad_norm) on one rank of
    ``mesh``: the loss and the gradient averaged over the data axes the
    batch is cut over, ``grads`` this rank's blocks of it (``params``'
    layout), ``grad_norm`` the whole gradient's. ``make_sharded_train_step``
    adds the AdamW update; see there."""
    shape = shd.MeshShape.from_mesh(mesh)
    pspecs = shd.param_specs(init_params(None, cfg, device="meta"), cfg,
                             shape)
    lead = shd.batch_specs(cfg, shape, global_batch)["labels"][0]
    cut_over = shd.dp_axes(shape) if lead is not None else ()

    def data_mean(loss, grads):
        for a in cut_over:
            group = mesh.axis(a)
            grads = tree_map(lambda g: group_mean(g, group, donate=True),
                             grads)
            loss = group.all_reduce_(loss.reshape(1))[0] / group.size
        return loss, grads

    if not split_model:
        def plain(params, batch):
            full = shd.gather_tree(params, pspecs, mesh)
            loss, grads = _value_and_grad(full, batch, cfg, remat=remat)
            del full
            loss, grads = data_mean(loss, grads)
            gnorm = global_norm(grads)
            return (loss, shd.shard_tree(grads, pspecs, shape, mesh.coords),
                    gnorm)
        return plain

    view = shd.model_view(cfg, shape, mesh.coords.get("model", 0))
    model = mesh.axis("model") if "model" in mesh.groups else None
    dspecs = shd.data_specs(pspecs, shape)
    spec_list = shd.spec_leaves(pspecs)

    def split(params, batch):
        local = _model_blocks(params, pspecs, mesh, view)
        loss, grads = _value_and_grad(local, batch, cfg, remat=remat,
                                      model=model)
        del local
        if view.embed_cut:
            grads["embed"] = grads["embed"].flatten(-2)
        if split_axis(model):
            names, leaves, structure = _tree.flatten_with_names(grads)
            leaves = [model.all_reduce_(g.to(torch.float32, copy=True))
                      .to(g.dtype)
                      if shd.partial_over_model(n, spec, view.whole) else g
                      for n, g, spec in zip(names, leaves, spec_list)]
            grads = _tree.unflatten(structure, leaves)
        loss, grads = data_mean(loss, grads)
        gnorm = (_split_norm(grads, pspecs, model) if split_axis(model)
                 else global_norm(grads))
        return loss, shd.shard_tree(grads, dspecs, shape, mesh.coords), gnorm

    return split


def make_sharded_train_step(cfg: ModelConfig, opt: AdamWConfig, mesh, *,
                            global_batch: int, remat=True,
                            split_model: bool = False):
    """(params, opt_state, batch) -> (params, opt_state, metrics) on one
    rank of ``mesh`` (a ``launch/mesh.Mesh`` over ("pod"?, "data",
    "model")), whose state holds only this rank's blocks
    (``models/sharding.shard_tree`` by ``param_specs``; the moments by the
    same specs, the step counter whole) and whose ``batch`` is its shard of
    the global batch (``shard_tree`` by ``batch_specs``).

    ``split_model=False``: a step gathers each leaf whole
    (``gather_tree``), runs ``loss_fn`` on the batch shard, averages the
    loss and the gradients (f32) over the data axes the batch is cut over,
    clips by the whole gradient's norm and updates only this rank's
    blocks. Every rank of a data shard repeats the compute.

    ``split_model=True`` (the configurations ``sharding.model_view``
    admits: every registered architecture on the reference's production
    meshes, query, mLSTM and sLSTM heads that do not divide over "model"
    included, each rank computing its ``sharding.share`` of whole heads;
    a tied head, each rank's vocabulary rows of the embedding
    (``models/transformer._tied_logits``); RG-LRU and sLSTM channels that
    do not divide, that mixer whole on every rank): a step gathers over
    the data axes only, so each rank keeps its model blocks (the
    reference's ZeRO-3 over "data"), and runs the forward and backward
    split over "model" (``forward(..., model=)``, the vocabulary-parallel
    ``loss_fn``). The gradients each rank holds a part of
    (``sharding.partial_over_model``: a whole leaf read at the rank's heads
    among them; never a whole mixer's, which are equal on every rank) are
    summed over "model" (f32), every gradient averaged over the data axes,
    and the global norm counts each element once. A tied embedding's
    gradient is the rank's own block, the head's share of it included.

    Either way the math is the reference's step on the global batch: its
    MoE routes each data shard's tokens on their own (``activation_specs``'
    ``n_dp``), and a rank's batch shard is exactly such a shard, so it
    routes its tokens together. ``remat``: ``forward``'s."""
    vg = make_sharded_value_and_grad(cfg, mesh, global_batch=global_batch,
                                     remat=remat, split_model=split_model)

    def step(params, opt_state, batch):
        loss, grads, gnorm = vg(params, batch)
        new_params, new_opt, gnorm = adamw_update(
            grads, opt_state, params, opt, donate=True, gnorm=gnorm)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return step


def _mesh_length_group(cfg: ModelConfig, mesh, global_batch: int):
    """The group a decode cache's length is cut over on ``mesh``
    (``sharding.length_axes``), ``None`` where it is not cut."""
    axes = shd.length_axes(cfg, shd.MeshShape.from_mesh(mesh), global_batch)
    group = mesh.group(axes) if axes else None
    return group if split_axis(group) else None


def make_sharded_serve_step(cfg: ModelConfig, mesh, global_batch: int):
    """(prefill, decode) on one rank of ``mesh``, the compute split over
    "model": the twin of the prefill and decode programs the reference's
    dry run lowers on its mesh (``repro/launch/dryrun.py``).

    The configurations are those ``sharding.model_view`` admits: the
    attention families, recurrentgemma-2b (RG-LRU, and windowed attention
    whose one kv head does not divide), xlstm-1.3b (mLSTM, sLSTM),
    paligemma-3b (patch embeddings spliced over the gathered activations)
    and musicgen-medium (K codebook tables, a head of K V columns), with
    query, mLSTM and sLSTM heads that do not divide over "model" (each
    rank its ``sharding.share`` of whole heads, none on some where there
    are fewer heads than ranks: such a rank launches no kernel and joins
    every collective), so all ten on the reference's production meshes. Both
    take the rank's stored blocks (``param_specs``) and gather them over
    the data axes. ``prefill(params, batch)`` -> this rank's block of the
    head's columns (``forward``'s), for its shard of the batch
    (``batch_specs``: tokens and, for the VLM, ``patch_embeds``), through
    the flash kernel on the rank's query heads against the kv heads they
    read.
    ``decode(params, state, tokens)`` -> (logits, state): one token (text
    only, as in the reference) against ``state`` from
    ``sharded_decode_state``, cut as ``decode_state_specs`` cuts it: the
    kv heads over "model" where they divide, else every kv head; the
    cache's length over ``sharding.length_axes`` ("model" where the kv
    heads do not divide; where the batch does not divide over the data
    axes, each data rank runs the whole batch and the length is cut over
    those axes too), a ring that does not divide over them whole on every
    rank; the recurrent states' channels and heads (mLSTM's whole where
    its heads do not divide, sLSTM's a channel block that may end
    mid-head; a whole mixer's state whole), whole over the data axes. A
    tied head's logits come from the rank's vocabulary rows: by an
    all-to-all of the embedding at prefill, by an f32 reduce-scatter of
    each rank's part at decode (``models/transformer._tied_logits``).
    ``model_view``'s refusals raise."""
    shape = shd.MeshShape.from_mesh(mesh)
    view = shd.model_view(cfg, shape, mesh.coords.get("model", 0))
    model = mesh.axis("model") if "model" in mesh.groups else None
    length = _mesh_length_group(cfg, mesh, global_batch)
    pspecs = shd.param_specs(init_params(None, cfg, device="meta"), cfg,
                             shape)

    def prefill(params, batch):
        with torch.inference_mode():
            local = _model_blocks(params, pspecs, mesh, view)
            return forward(local, batch, cfg, model=model)

    def decode(params, state, tokens):
        with torch.inference_mode():
            local = _model_blocks(params, pspecs, mesh, view)
            return decode_step(local, state, tokens, cfg, model=model,
                               length=length)

    return prefill, decode


def sharded_decode_state(cfg: ModelConfig, mesh, global_batch: int,
                         max_len: int, *, device=None):
    """A rank's decode state for ``make_sharded_serve_step``'s decode:
    ``init_decode_state`` of its rows of the batch (``batch_specs``: all of
    them where the batch does not divide over the data axes) with the
    mesh's "model" axis and length group, as ``decode_state_specs`` plans
    it."""
    shape = shd.MeshShape.from_mesh(mesh)
    return init_decode_state(
        cfg, global_batch // shd.dp_shards(cfg, shape, global_batch),
        max_len, device=mesh.device if device is None else device,
        model=mesh.axis("model") if "model" in mesh.groups else None,
        length=_mesh_length_group(cfg, mesh, global_batch))


def make_serve_step(cfg: ModelConfig):
    """(params, state, tokens) -> (logits, state): one decode step."""

    def serve(params, state, tokens):
        with torch.inference_mode():
            return decode_step(params, state, tokens, cfg)

    return serve
