"""Train and serve steps: the twin of ``repro/train/step.py``.

``make_train_step``      one rank's step: loss, autograd, AdamW.
``make_psa_train_step``  the paper-integrated step: each pod is one rank of
                         the pod axis (an ``AxisGroup``), and the cross-pod
                         gradient reduction goes through PSA subspace
                         compression (optim/psa_compress.py), whose
                         projector S-DOT keeps over the pod ring.
``make_sharded_train_step``  one rank of a (pod?, data, model) mesh that
                         stores only its blocks of the parameters and AdamW
                         moments (models/sharding.py's rules), gathers
                         each leaf for the step and keeps its own block of
                         the update.
``make_serve_step``      one-token decode with the KV caches.

The reference trains through plain attention (``use_pallas=False``): the
flash kernel has no backward in either package, so ``loss_fn`` runs
``forward(..., use_kernel=False)``. The reference's remat is left out (it
only trades memory for recomputation).
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import _tree
from ..configs.base import ModelConfig, PSAConfig
from ..models import sharding as shd
from ..models.transformer import decode_step, forward, init_params, tree_map
from ..optim.adamw import AdamWConfig, adamw_update, global_norm
from ..optim.psa_compress import compress_grads, group_mean, psa_refresh

__all__ = ["loss_fn", "make_train_step", "make_psa_train_step",
           "make_sharded_train_step", "make_serve_step", "shard_batch"]


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            act_specs=None) -> torch.Tensor:
    """Mean next-token cross entropy from float32 logits. The gold logit is
    read by index: the reference's masked sum over the vocabulary adds one
    logit to zeros, the same value. ``act_specs`` as ``forward`` takes it
    (only its ``"moe"`` entry acts)."""
    logits = forward(params, batch, cfg, use_kernel=False,
                     act_specs=act_specs).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def _value_and_grad(params, batch, cfg: ModelConfig):
    """(loss, grads): one backward pass, grads in the parameters' dtypes
    and tree."""
    _, leaves, structure = _tree.flatten_with_names(params)
    live = [leaf.detach().requires_grad_() for leaf in leaves]
    with torch.enable_grad():
        loss = loss_fn(_tree.unflatten(structure, live), batch, cfg)
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
                    donate: bool = True):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``group``: a data-parallel axis (``AxisGroup``) whose ranks each take a
    shard of the batch: the gradient and the loss are their f32 means, as
    the reference's XLA all-reduce over its data axes. ``None``: one rank.
    ``donate``: AdamW writes into the given parameters and moments."""

    def step(params, opt_state, batch):
        loss, grads = _value_and_grad(params, batch, cfg)
        if group is not None:
            grads = tree_map(
                lambda g: group_mean(g, group, donate=donate), grads)
            loss = group.all_reduce_(loss.reshape(1))[0] / group.size
        new_params, new_opt, gnorm = adamw_update(grads, opt_state, params,
                                                  opt, donate=donate)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return step


def make_psa_train_step(cfg: ModelConfig, opt: AdamWConfig, psa: PSAConfig,
                        *, group, donate: bool = True):
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
    same holds: the head's contribution is in the same leaf.
    """
    if group is None or group.size < 2:
        raise ValueError("PSA train step needs a pod axis of >= 2 pods")
    npods = group.size

    def step(params, opt_state, psa_state, batch):
        loss, grads = _value_and_grad(params, batch, cfg)
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
        _, grads = _value_and_grad(params, batch, cfg)
        return psa_refresh(grads, psa_state, psa, pod_axis=group)

    return step, refresh


def make_sharded_train_step(cfg: ModelConfig, opt: AdamWConfig, mesh, *,
                            global_batch: int):
    """(params, opt_state, batch) -> (params, opt_state, metrics) on one
    rank of ``mesh`` (a ``launch/mesh.Mesh`` over ("pod"?, "data",
    "model")), whose state holds only this rank's blocks
    (``models/sharding.shard_tree`` by ``param_specs``; the moments by the
    same specs, the step counter whole) and whose ``batch`` is its shard of
    the global batch (``shard_tree`` by ``batch_specs``).

    A step gathers each leaf whole (``gather_tree``), runs ``loss_fn`` on
    the batch shard, averages the loss and the gradients (f32) over the
    data axes the batch is cut over, clips by the whole gradient's norm and
    updates only this rank's blocks. The math is the reference's step on
    the global batch: its MoE routes each data shard's tokens on their own
    (``activation_specs``' ``n_dp``), and a rank's batch shard is exactly
    such a shard, so it routes its tokens together. The compute is not
    split over "model" (every rank of a data shard repeats it)."""
    shape = shd.MeshShape.from_mesh(mesh)
    pspecs = shd.param_specs(init_params(None, cfg, device="meta"), cfg,
                             shape)
    lead = shd.batch_specs(cfg, shape, global_batch)["labels"][0]
    cut_over = shd.dp_axes(shape) if lead is not None else ()

    def step(params, opt_state, batch):
        full = shd.gather_tree(params, pspecs, mesh)
        loss, grads = _value_and_grad(full, batch, cfg)
        del full
        for a in cut_over:
            group = mesh.axis(a)
            grads = tree_map(lambda g: group_mean(g, group, donate=True),
                             grads)
            loss = group.all_reduce_(loss.reshape(1))[0] / group.size
        gnorm = global_norm(grads)
        grads = shd.shard_tree(grads, pspecs, shape, mesh.coords)
        new_params, new_opt, gnorm = adamw_update(
            grads, opt_state, params, opt, donate=True, gnorm=gnorm)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return step


def make_serve_step(cfg: ModelConfig):
    """(params, state, tokens) -> (logits, state): one decode step."""

    def serve(params, state, tokens):
        with torch.inference_mode():
            return decode_step(params, state, tokens, cfg)

    return serve
