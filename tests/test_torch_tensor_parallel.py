"""The compute split over "model" (tensor parallelism) over gloo ranks
(CPU), against one process, the unsplit route and the reference.

One spawn of 4 gloo ranks lays a (2, 2) ("data", "model") mesh out. Each
rank holds its blocks of the parameters (``models/sharding.shard_tree`` by
``param_specs``) and, for reduced h2o-danube-1.8b (sliding window),
qwen2-7b (qkv bias, GQA), phi3.5-moe (experts over "model", capacity
MOE_CF so that routing drops pairs), recurrentgemma-2b (RG-LRU, and a
windowed attention whose one kv head does not divide: window RING, so that
decode wraps the ring and a rank's slots start empty), xlstm-1.3b (mLSTM,
sLSTM; widened to XLSTM_D so that 4 mLSTM and 2 sLSTM heads divide),
paligemma-3b (patch embeddings spliced over the gathered activations, its
one kv head) and musicgen-medium (4 codebook tables, a head of 4 x V
columns, 2 codebooks a rank), runs
``make_sharded_value_and_grad(split_model=True)`` at each remat, the
unsplit route (``split_model=False``), one split AdamW step, and
``make_sharded_serve_step``'s prefill and ``DECODE_STEPS`` decode steps.
Then the LONG cases decode a batch of 1, which does not divide over
"data": h2o-danube's cache cut by length over "data" (its kv heads over
"model"), recurrentgemma's over ("data", "model"), xlstm's states whole
over "data"; and recurrentgemma with a ring of RING - 1 slots, which does
not divide over "model" and is whole on every rank. The same ranks then
lay (1, 4) out for the QUAD cases (qwen2-7b's 2 kv heads, xlstm's whole
sLSTM FFN leaves, musicgen with 2 codebooks, each cut mid-vocabulary over
two ranks), run the HEADS cases (query, mLSTM and sLSTM heads that do not
divide over "model", on (1, 4) or (2, 2): a rank computes whole heads, its
``sharding.share``, while ``wq``'s and the mixers' stored blocks end
mid-head), the UNEVEN cases (a tied head; RG-LRU and sLSTM channels that
do not divide over "model", that mixer whole on every rank), check the
new collectives' gradients and lay a mesh over two of them. Last, the
KV_QUANT cases decode with the int8 KV cache (``kv_quant``): qwen2-7b on
(2, 2), its kv heads over "model" (a whole ring a rank,
``attention._decode_ring``), h2o-danube at batch 1 with its cache cut by
length over "data" and qwen2-7b on (1, 4) with its 2 kv heads cut by
length over "model" (``attention._decode_by_length``).

Held: the loss against one process's ``loss_fn`` on the global batch (its
MoE routed per data shard, ``act_specs["moe"]["n_dp"]`` = 2, as the split
step's ranks route their shards) and against the reference's; the
gradients, gathered back, against one process and the unsplit route;
the three remats' gradients bit for bit (HEADS: remat True alone); the
norms' gradients and the MoE
routes equal on the model ranks of a data shard; the prefill's and
decode's logits against one process's ``forward`` / ``decode_step``; the
wire bytes a rank counted equal to ``roofline.step_wire_bytes`` exactly,
and the model axis's all-reduces: as many more under ``"names"`` than
under ``False`` as the mixers run inside their spans (mLSTM's gate sum),
and under ``True`` the forward's again; the decode states' bytes equal to
the dry run's plan (KV_QUANT: ``k_scale`` / ``v_scale`` included). A
tied head with the audio frontend raises
``ValueError``, as the reference fails there.

The ranks start by ``spawn`` and import this module: it imports no JAX at
module level. Tolerances: F32_TOL relative (f32 sums in another order:
partial products summed over ranks); the gradients within F32_TOL of their
leaf's largest; the logits within SERVE_TOL of their largest. The AdamW
step is held to AdamW of the split gradient bit for bit, not to the other
route's step: a first step moves an element by ~lr times the sign of its
gradient, so elements whose gradient is ~0 flip with the summation order.
"""
import dataclasses
import math
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch import configs as tcfg
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import roofline
from repro_torch.launch.mesh import Mesh, spawn_ranks
from repro_torch.models import moe
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tt
from repro_torch.optim.adamw import AdamWConfig

F32_TOL = 2e-5
SERVE_TOL = 1e-5
SPLIT = ("h2o-danube-1.8b", "qwen2-7b", "phi3.5-moe-42b-a6.6b",
         "recurrentgemma-2b", "xlstm-1.3b", "paligemma-3b",
         "musicgen-medium")
REMATS = (False, True, "names")
MESH = (("data", 2), ("model", 2))
KV_MESH = (("data", 1), ("model", 4))
# on KV_MESH: qwen2's 2 kv heads over 4 (the cache cut by length), xlstm
# at width 1024, whose sLSTM FFN (f = 1365) keeps w_ffn_up and w_ffn_down
# whole over 4: each rank reads its part of them, and musicgen with 2
# codebooks, whose K V = 512 head columns put each codebook on two ranks
# (and whose 2 kv heads over 4 cut its cache by length)
QUAD = {"kv_heads": ("qwen2-7b", {}),
        "whole_ffn": ("xlstm-1.3b", {"d_model": 1024}),
        "codebook_cut": ("musicgen-medium", {"n_codebooks": 2})}
QUAD_REF = ("codebook_cut",)    # QUAD cases with over held to the reference
SB, SS = 4, 16
DECODE_STEPS = {"recurrentgemma-2b": 12}      # past the ring's wrap
# a batch of 1 on MESH (max_len, decode steps): h2o-danube's ring of 8
# slots cut over "data" (4 a rank), recurrentgemma's of RING cut over
# ("data", "model") (2 a rank), both wrapped; xlstm's states
LONG = {"h2o-danube-1.8b": (8, 12), "recurrentgemma-2b": (SS, 12),
        "xlstm-1.3b": (SS, 4)}
WHOLE_RING = "ring_whole"       # recurrentgemma, window RING - 1, on MESH
MOE_CF = 0.5
RING = 8                        # recurrentgemma's window: a ring of 8 slots
XLSTM_D = 256                   # 4 mLSTM heads, 2 sLSTM heads of 128
N_DP = {"moe": {"n_dp": 2}}     # one process routing as the data shards do
# heads that do not divide over "model" (case: arch, overrides, mesh), each
# rank computing its share of whole heads (the first n % tp one more):
# recurrentgemma's 6 query heads over 4 (2, 2, 1, 1; wq's block 1.5 heads;
# its one kv head gathered; its ring of RING slots cut by length and
# wrapped; one RG-LRU and one windowed layer), qwen2's 6 / 2 over 4 (rank 1's heads 2-3 read kv heads 0 and
# 1), 6 / 3 over 2 (each rank's 3 heads straddle a group of 2), paligemma's
# 2 heads over 4 (two ranks hold none, as paligemma-3b's 8 over 16),
# musicgen's 6 = 6 heads (MHA) over 4, xlstm at width 64 (1 mLSTM and 1
# sLSTM head over 2: one rank holds none; over 4, three hold none and
# mLSTM's w_if (128, 2) is kept whole, each rank reading its block's rows)
# and 384 (3 sLSTM heads over 2, whose channel block ends mid-head)
HEADS = {
    "q_heads": ("qwen2-7b", {"n_heads": 6, "n_kv_heads": 2, "head_dim": 16},
                KV_MESH),
    "kv_groups": ("qwen2-7b", {"n_heads": 6, "n_kv_heads": 3,
                               "head_dim": 16}, MESH),
    "rg_heads": ("recurrentgemma-2b", {"n_heads": 6, "window": RING,
                                       "block_pattern": ("rglru", "swa"),
                                       "n_layers": 2}, KV_MESH),
    "empty_ranks": ("paligemma-3b", {"n_heads": 2}, KV_MESH),
    "mha_heads": ("musicgen-medium", {"n_heads": 6, "n_kv_heads": 6,
                                      "head_dim": 16}, KV_MESH),
    "mlstm_heads": ("xlstm-1.3b", {"d_model": 64}, MESH),
    "slstm_heads": ("xlstm-1.3b", {"d_model": 384}, MESH),
    "one_head_over_4": ("xlstm-1.3b", {"d_model": 64}, KV_MESH),
}
HEADS_REF = ("q_heads", "kv_groups", "rg_heads")   # also to the reference
# a tied head (qwen2 on MESH and on KV_MESH: each rank's vocabulary rows of
# the embedding by an all-to-all, at decode an f32 reduce-scatter of each
# rank's part), RG-LRU channels that do not divide over "model"
# (recurrentgemma at width 66 over 4: the mixer whole on every rank, the
# embedding whole), both at once (tied_channels: a whole table sliced to a
# rank's rows), and sLSTM channels (xlstm at width 62 over 4, the nearest
# width to 66 the reference's mLSTM admits (one head of 124): the sLSTM
# mixer whole, its gate and FFN columns gathered). Each held to one
# process and to the reference (loss and gradients), at remat True.
_RG66 = {"d_model": 66, "window": RING, "block_pattern": ("rglru", "swa"),
         "n_layers": 2}
UNEVEN = {
    "tied": ("qwen2-7b", {"tie_embeddings": True}, MESH),
    "tied_quad": ("qwen2-7b", {"tie_embeddings": True}, KV_MESH),
    "rglru_channels": ("recurrentgemma-2b", _RG66, KV_MESH),
    "tied_channels": ("recurrentgemma-2b", {**_RG66, "tie_embeddings": True},
                      KV_MESH),
    "slstm_channels": ("xlstm-1.3b", {"d_model": 62}, KV_MESH),
}

# the int8 KV cache under the split decode (case: arch, mesh, batch,
# max_len, decode steps), each held to one process with the int8 cache
KV_QUANT = {"int8_ring": ("qwen2-7b", MESH, SB, SS, 4),
            "int8_by_length": ("h2o-danube-1.8b", MESH, 1, 8, 12),
            "int8_kv_heads": ("qwen2-7b", KV_MESH, SB, SS, 4)}


def _cfg(configs, aid, **over):
    over = over or {"recurrentgemma-2b": {"window": RING},
                    "xlstm-1.3b": {"d_model": XLSTM_D}}.get(aid, {})
    cfg = configs.reduced_config(configs.get_arch(aid), **over)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_CF))
    return cfg


def _steps(aid) -> int:
    return DECODE_STEPS.get(aid, 4)


def _inputs(batch):
    """A batch's model inputs: tokens, and the VLM's patch embeddings."""
    return {k: v for k, v in batch.items() if k != "labels"}


def _ring_cfg(configs):
    return dataclasses.replace(_cfg(configs, "recurrentgemma-2b"),
                               window=RING - 1)


def _counters(mesh):
    return {a: (dict(g.wire_bytes), dict(g.calls))
            for a, g in mesh.groups.items()}


def _since(mesh, before):
    return {a: ({k: g.wire_bytes[k] - before[a][0][k] for k in g.wire_bytes},
                {k: g.calls[k] - before[a][1][k] for k in g.calls})
            for a, g in mesh.groups.items()}


def _rank(rank, world, dev, work):
    """Each SPLIT model on the (2, 2) mesh (module docstring)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.train.step import (make_sharded_serve_step,
                                        make_sharded_train_step,
                                        make_sharded_value_and_grad,
                                        sharded_decode_state)
    mesh = make_mesh(MESH, device=dev)
    shape = shd.MeshShape.from_mesh(mesh)
    out = {"coords": mesh.coords}
    inner = moe.route
    routes = []

    def recording(xf, router, m, cap):
        plan = inner(xf, router, m, cap)
        routes.append([t.clone() for t in plan])
        return plan

    moe.route = recording
    for aid in SPLIT:
        cfg = _cfg(tcfg, aid)
        full = torch.load(os.path.join(work, f"{aid}.pt"))
        batch = torch.load(os.path.join(work, f"{aid}_batch.pt"))
        pspecs = shd.param_specs(full, cfg, shape)
        params = shd.shard_tree(full, pspecs, shape, mesh.coords)
        local = shd.shard_tree(batch, shd.batch_specs(cfg, shape, SB), shape,
                               mesh.coords)
        res = {"remat": {}}
        for remat in REMATS:
            vg = make_sharded_value_and_grad(cfg, mesh, global_batch=SB,
                                             remat=remat, split_model=True)
            routes.clear()
            before = _counters(mesh)
            loss, grads, gnorm = vg(params, local)
            wire = _since(mesh, before)
            res["remat"][remat] = {
                "loss": float(loss), "grad_norm": float(gnorm),
                "wire": wire, "routes": list(routes),
                "norms": {n: g for n, g in zip(
                    *_tree.flatten_with_names(grads)[:2])
                    if n.split("/")[-1] in ("norm1", "norm2", "final_norm")},
                "grads": shd.gather_tree(grads, pspecs, mesh)}
        vg = make_sharded_value_and_grad(cfg, mesh, global_batch=SB,
                                         split_model=False)
        loss, grads, gnorm = vg(params, local)
        res["plain"] = {"loss": float(loss), "grad_norm": float(gnorm),
                        "grads": shd.gather_tree(grads, pspecs, mesh)}
        opt = AdamWConfig(warmup_steps=1)
        step = make_sharded_train_step(cfg, opt, mesh, global_batch=SB,
                                       split_model=True)
        p = tt.tree_map(lambda x: x.clone(), params)
        p, _, met = step(p, adamw_init(p, opt), local)
        loss, grads, gnorm = make_sharded_value_and_grad(
            cfg, mesh, global_batch=SB, split_model=True)(params, local)
        q = tt.tree_map(lambda x: x.clone(), params)
        q, _, _ = adamw_update(grads, adamw_init(q, opt), q, opt,
                               donate=True, gnorm=gnorm)
        res["step"] = {"loss": float(met["loss"]),
                       "grad_norm": float(met["grad_norm"]),
                       "equal": all(torch.equal(a, b) for a, b in zip(
                           _tree.tree_leaves(p), _tree.tree_leaves(q)))}
        prefill, decode = make_sharded_serve_step(cfg, mesh, SB)
        before = _counters(mesh)
        res["prefill"] = prefill(params, _inputs(local))
        res["prefill_wire"] = _since(mesh, before)
        state = sharded_decode_state(cfg, mesh, SB, SS)
        res["decode"], res["decode_wire"] = [], []
        for t in range(_steps(aid)):
            before = _counters(mesh)
            logits, state = decode(params, state,
                                   local["tokens"][:, t:t + 1])
            res["decode_wire"].append(_since(mesh, before))
            res["decode"].append(logits)
        out[aid] = res
    moe.route = inner
    out["long"] = _long_ranks(mesh, work)
    quad = make_mesh(KV_MESH, device=dev)
    out["quad"] = _quad_ranks(quad, work)
    out["heads"] = _heads_ranks({MESH: mesh, KV_MESH: quad}, work)
    out["uneven"] = _heads_ranks({MESH: mesh, KV_MESH: quad}, work, UNEVEN)
    out["int8"] = _int8_ranks({MESH: mesh, KV_MESH: quad}, work)
    out["collective"] = _collective_grads(mesh)
    out["sub"] = _sub_mesh(rank, dev)
    return out


def _decode_run(cfg, mesh, params, tokens, global_batch, max_len, steps):
    """``steps`` teacher-forced decode steps of ``make_sharded_serve_step``
    from ``sharded_decode_state``: the logits, the wire bytes of each, the
    state's tensor bytes and its caches' shapes."""
    from repro_torch.train.step import (make_sharded_serve_step,
                                        sharded_decode_state)
    _, decode = make_sharded_serve_step(cfg, mesh, global_batch)
    state = sharded_decode_state(cfg, mesh, global_batch, max_len)
    names, leaves, _ = _tree.flatten_with_names(state["caches"])
    res = {"state_bytes": sum(x.numel() * x.element_size() for x in leaves),
           "cache_shapes": {n.lstrip("/"): tuple(x.shape)
                            for n, x in zip(names, leaves)},
           "decode": [], "decode_wire": []}
    for t in range(steps):
        before = _counters(mesh)
        logits, state = decode(params, state, tokens[:, t:t + 1])
        res["decode_wire"].append(_since(mesh, before))
        res["decode"].append(logits)
    return res


def _long_ranks(mesh, work):
    """Each LONG case: a batch of 1 (the global batch's first row, whole
    on every rank) decoded on MESH; then WHOLE_RING on the SPLIT batch."""
    shape = shd.MeshShape.from_mesh(mesh)
    out = {}
    for aid, (max_len, steps) in LONG.items():
        cfg = _cfg(tcfg, aid)
        full = torch.load(os.path.join(work, f"{aid}.pt"))
        tokens = torch.load(os.path.join(work, f"{aid}_batch.pt"))["tokens"]
        params = shd.shard_tree(full, shd.param_specs(full, cfg, shape),
                                shape, mesh.coords)
        out[aid] = _decode_run(cfg, mesh, params, tokens[:1], 1, max_len,
                               steps)
    cfg = _ring_cfg(tcfg)
    full = torch.load(os.path.join(work, "recurrentgemma-2b.pt"))
    batch = torch.load(os.path.join(work, "recurrentgemma-2b_batch.pt"))
    local = shd.shard_tree(batch, shd.batch_specs(cfg, shape, SB), shape,
                           mesh.coords)
    params = shd.shard_tree(full, shd.param_specs(full, cfg, shape), shape,
                            mesh.coords)
    out[WHOLE_RING] = _decode_run(cfg, mesh, params, local["tokens"], SB, SS,
                                  _steps("recurrentgemma-2b"))
    return out


def _int8_ranks(meshes, work):
    """Each KV_QUANT case: ``_decode_run`` with the int8 KV cache on its
    mesh, the batch sharded (a batch of 1 whole on every rank)."""
    out = {}
    for case, (aid, sizes, batch, max_len, steps) in KV_QUANT.items():
        mesh = meshes[sizes]
        shape = shd.MeshShape.from_mesh(mesh)
        cfg = dataclasses.replace(_cfg(tcfg, aid), kv_quant=True)
        full = torch.load(os.path.join(work, f"{aid}.pt"))
        params = shd.shard_tree(full, shd.param_specs(full, cfg, shape),
                                shape, mesh.coords)
        tokens = torch.load(os.path.join(work, f"{aid}_batch.pt"))["tokens"]
        if batch == 1:
            tokens = tokens[:1]
        else:
            tokens = shd.shard_tree(
                {"tokens": tokens},
                {"tokens": shd.batch_specs(cfg, shape, batch)["tokens"]},
                shape, mesh.coords)["tokens"]
        out[case] = {"coords": mesh.coords, **_decode_run(
            cfg, mesh, params, tokens, batch, max_len, steps)}
    return out


def _sub_mesh(rank, dev):
    """Global ranks 1 and 3 laid out as a model axis of 2 (every rank
    makes the groups): the sum over it of each member's rank, reduced and
    reduce-scattered; ``None`` on the others."""
    from repro_torch.launch.mesh import make_mesh
    sub = make_mesh((("data", 1), ("model", 2)), device=dev, ranks=[1, 3])
    if sub is None:
        return None
    ax = sub.axis("model")
    return {"coords": sub.coords, "ranks": ax.ranks,
            "sum": float(ax.all_reduce_(torch.tensor([float(rank)]))[0]),
            "scattered": ax.reduce_scatter(torch.full((4,), float(rank)))}


def _quad_ranks(mesh, work):
    """Each QUAD case on ``mesh`` (KV_MESH): a train value and gradient,
    the prefill and decode, with the wire bytes of each."""
    from repro_torch.train.step import (make_sharded_serve_step,
                                        make_sharded_value_and_grad,
                                        sharded_decode_state)
    shape = shd.MeshShape.from_mesh(mesh)
    out = {}
    for case, (aid, over) in QUAD.items():
        cfg = _cfg(tcfg, aid, **over)
        full = torch.load(os.path.join(work, f"{case}.pt"))
        batch = torch.load(os.path.join(work, f"{case}_batch.pt"))
        pspecs = shd.param_specs(full, cfg, shape)
        params = shd.shard_tree(full, pspecs, shape, mesh.coords)
        before = _counters(mesh)
        loss, grads, gnorm = make_sharded_value_and_grad(
            cfg, mesh, global_batch=SB, split_model=True)(params, batch)
        res = {"coords": mesh.coords, "loss": float(loss),
               "grad_norm": float(gnorm), "wire": _since(mesh, before),
               "grads": shd.gather_tree(grads, pspecs, mesh)}
        prefill, decode = make_sharded_serve_step(cfg, mesh, SB)
        before = _counters(mesh)
        res["prefill"] = prefill(params, _inputs(batch))
        res["prefill_wire"] = _since(mesh, before)
        state = sharded_decode_state(cfg, mesh, SB, SS)
        names, leaves, _ = _tree.flatten_with_names(state["caches"])
        res["cache_shapes"] = {n.lstrip("/"): tuple(x.shape)
                               for n, x in zip(names, leaves)}
        res["decode"], res["decode_wire"] = [], []
        for t in range(_steps(aid)):
            before = _counters(mesh)
            logits, state = decode(params, state,
                                   batch["tokens"][:, t:t + 1])
            res["decode_wire"].append(_since(mesh, before))
            res["decode"].append(logits)
        out[case] = res
    return out


def _heads_ranks(meshes, work, cases=HEADS):
    """Each HEADS (or UNEVEN) case on its mesh (``meshes`` by its sizes):
    the train value and gradient at remat True, the prefill with the flash
    calls it made, ``_decode_run``'s decode from a fresh state, the wire
    bytes of each."""
    from repro_torch.kernels import ops
    from repro_torch.train.step import (make_sharded_serve_step,
                                        make_sharded_value_and_grad)
    inner, calls = ops.flash_attention, []

    def counted(q, *args, **kw):
        calls.append(q.shape[1])
        return inner(q, *args, **kw)

    out = {}
    for case, (aid, over, sizes) in cases.items():
        mesh = meshes[sizes]
        shape = shd.MeshShape.from_mesh(mesh)
        cfg = _cfg(tcfg, aid, **over)
        full = torch.load(os.path.join(work, f"{case}.pt"))
        batch = torch.load(os.path.join(work, f"{case}_batch.pt"))
        pspecs = shd.param_specs(full, cfg, shape)
        params = shd.shard_tree(full, pspecs, shape, mesh.coords)
        local = shd.shard_tree(batch, shd.batch_specs(cfg, shape, SB), shape,
                               mesh.coords)
        before = _counters(mesh)
        loss, grads, gnorm = make_sharded_value_and_grad(
            cfg, mesh, global_batch=SB, split_model=True)(params, local)
        res = {"coords": mesh.coords, "loss": float(loss),
               "grad_norm": float(gnorm), "wire": _since(mesh, before),
               "grads": shd.gather_tree(grads, pspecs, mesh)}
        prefill, _ = make_sharded_serve_step(cfg, mesh, SB)
        before = _counters(mesh)
        calls.clear()
        ops.flash_attention = counted
        res["prefill"] = prefill(params, _inputs(local))
        ops.flash_attention = inner
        res["flash_calls"] = list(calls)
        res["prefill_wire"] = _since(mesh, before)
        res.update(_decode_run(cfg, mesh, params, local["tokens"], SB, SS,
                               _steps(aid)))
        out[case] = res
    return out


def _collective_grads(mesh):
    """The gradient a model rank gets for its block x of X (4, 6) through
    ``gather_summed_from_model`` and through ``gather_from_model``, where
    each rank's consumer of the whole differs: loss_r = sum(whole * (r +
    1) W). The whole loss sums both ranks', so X's gradient is 3 W."""
    from repro_torch.launch.mesh import (gather_from_model,
                                         gather_summed_from_model)
    ax = mesh.axis("model")
    gen = torch.Generator().manual_seed(7)
    big_x, w = torch.randn(4, 6, generator=gen), torch.randn(4, 6,
                                                             generator=gen)
    out = {"index": ax.index}
    for name, fn in (("summed", gather_summed_from_model),
                     ("plain", gather_from_model)):
        x = big_x[:, 3 * ax.index:3 * ax.index + 3].clone().requires_grad_()
        whole = fn(x, ax, dim=-1)
        (whole * (ax.index + 1) * w).sum().backward()
        out[name] = x.grad
    out["want"] = (3 * w)[:, 3 * ax.index:3 * ax.index + 3]
    out["whole_equal"] = torch.equal(whole.detach(), big_x)
    return out


def _assemble(ranks, key):
    """The global (b, s, C) logits (C = V, audio's K V codebook-major) from
    each rank's (b / 2, s, C / 2), audio's (b / 2, s, K / 2, V)."""
    rows = {}
    for r in ranks:
        rows.setdefault(r["coords"]["data"], {})[r["coords"]["model"]] = \
            key(r).flatten(2)
    return torch.cat([torch.cat([rows[d][m] for m in sorted(rows[d])], -1)
                      for d in sorted(rows)], 0)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The ranks' results, and one process's and the reference's on the
    same parameters and batches."""
    import jax
    from repro import configs as jcfg
    from repro.train.step import loss_fn as jloss_fn
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.train.step import _value_and_grad
    work = str(tmp_path_factory.mktemp("tp"))
    aspecs = {"act": None, "logits": None, "attn_q": None, "attn_kv": None,
              "moe": {"dp": None, "e": None, "n_dp": 2}}

    def ref_loss(jc, params, batch):
        return float(jax.jit(lambda p, b: jloss_fn(
            p, b, jc, remat=False, act_specs=aspecs))(
            tt.tree_map(lambda t: t.numpy(), params),
            {k: v.numpy() for k, v in batch.items()}))

    def ref_value_and_grad(jc, params, batch):
        args = (tt.tree_map(lambda t: t.numpy(), params),
                {k: v.numpy() for k, v in batch.items()})
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(
            p, b, jc, remat=False, unroll_layers=True))).lower(*args).compile(
            {"xla_backend_optimization_level": 0})(*args)
        return float(loss), tt.tree_map(lambda a: torch.from_numpy(
            np.array(a)), dict(grads))

    def decoded(tc, params, tokens, max_len, steps, **kw):
        with torch.inference_mode():
            state = tt.init_decode_state(tc, tokens.shape[0], max_len,
                                         device="cpu")
            out = []
            for t in range(steps):
                lg, state = tt.decode_step(params, state,
                                           tokens[:, t:t + 1], tc, **kw)
                out.append(lg)
        return out

    one = {}
    for aid in SPLIT:
        tc, jc = _cfg(tcfg, aid), _cfg(jcfg, aid)
        params = tt.init_params(torch.Generator().manual_seed(0), tc,
                                device="cpu")
        batch = make_lm_batch(tc, 0, 0, SB, SS, device="cpu")
        torch.save(params, os.path.join(work, f"{aid}.pt"))
        torch.save(batch, os.path.join(work, f"{aid}_batch.pt"))
        loss, grads = _value_and_grad(params, batch, tc, act_specs=N_DP)
        with torch.inference_mode():
            logits = tt.forward(params, _inputs(batch), tc, act_specs=N_DP)
        one[aid] = {"cfg": tc, "ref_loss": ref_loss(jc, params, batch),
                    "loss": float(loss), "grads": grads, "prefill": logits,
                    "decode": decoded(tc, params, batch["tokens"], SS,
                                      _steps(aid), act_specs=N_DP)}
        if aid in LONG:
            one[aid]["long"] = decoded(tc, params, batch["tokens"][:1],
                                       *LONG[aid])
        if aid == "recurrentgemma-2b":
            one[WHOLE_RING] = {"cfg": _ring_cfg(tcfg), "decode": decoded(
                _ring_cfg(tcfg), params, batch["tokens"], SS, _steps(aid))}
    for case, (aid, _, batch, max_len, steps) in KV_QUANT.items():
        tc = dataclasses.replace(_cfg(tcfg, aid), kv_quant=True)
        tokens = torch.load(os.path.join(work, f"{aid}_batch.pt"))["tokens"]
        one[case] = {"cfg": tc, "decode": decoded(
            tc, torch.load(os.path.join(work, f"{aid}.pt")), tokens[:batch],
            max_len, steps)}
    for case, (aid, over) in QUAD.items():
        tc = _cfg(tcfg, aid, **over)
        if not over:                # the (2, 2) run's model and batch
            for end in (".pt", "_batch.pt"):
                shutil.copy(os.path.join(work, aid + end),
                            os.path.join(work, case + end))
            one[case] = one[aid]
            continue
        params = tt.init_params(torch.Generator().manual_seed(0), tc,
                                device="cpu")
        batch = make_lm_batch(tc, 0, 0, SB, SS, device="cpu")
        torch.save(params, os.path.join(work, f"{case}.pt"))
        torch.save(batch, os.path.join(work, f"{case}_batch.pt"))
        loss, grads = _value_and_grad(params, batch, tc)
        with torch.inference_mode():
            logits = tt.forward(params, _inputs(batch), tc)
        one[case] = {"cfg": tc, "loss": float(loss), "grads": grads,
                     "ref_loss": (ref_loss(_cfg(jcfg, aid, **over), params,
                                           batch) if case in QUAD_REF
                                  else None),
                     "prefill": logits,
                     "decode": decoded(tc, params, batch["tokens"], SS,
                                       _steps(aid))}
    for case, (aid, over, _) in {**HEADS, **UNEVEN}.items():
        tc = _cfg(tcfg, aid, **over)
        params = tt.init_params(torch.Generator().manual_seed(0), tc,
                                device="cpu")
        batch = make_lm_batch(tc, 0, 0, SB, SS, device="cpu")
        torch.save(params, os.path.join(work, f"{case}.pt"))
        torch.save(batch, os.path.join(work, f"{case}_batch.pt"))
        loss, grads = _value_and_grad(params, batch, tc)
        with torch.inference_mode():
            logits = tt.forward(params, _inputs(batch), tc)
        one[case] = {"cfg": tc, "loss": float(loss), "grads": grads,
                     "ref_loss": (ref_loss(_cfg(jcfg, aid, **over), params,
                                           batch) if case in HEADS_REF
                                  else None),
                     "prefill": logits,
                     "decode": decoded(tc, params, batch["tokens"], SS,
                                       _steps(aid))}
        if case in UNEVEN:
            one[case]["ref_loss"], one[case]["ref_grads"] = \
                ref_value_and_grad(_cfg(jcfg, aid, **over), params, batch)
    ranks = spawn_ranks(_rank, 4, backend="gloo", device="cpu",
                        args=(work,))
    return ranks, one


def _leaf_errs(got, want):
    """Per leaf: max |got - want| / max |want|."""
    names, w, _ = _tree.flatten_with_names(want)
    return {n: float((g - x).abs().max()) / max(float(x.abs().max()), 1e-30)
            for n, g, x in zip(names, _tree.tree_leaves(got), w)}


@pytest.mark.parametrize("aid", SPLIT)
def test_split_loss_matches_one_process_and_reference(split, aid):
    ranks, one = split
    o = one[aid]
    np.testing.assert_allclose(o["loss"], o["ref_loss"], rtol=F32_TOL)
    for r in ranks:
        for remat in REMATS:
            got = r[aid]["remat"][remat]["loss"]
            np.testing.assert_allclose(got, o["loss"], rtol=F32_TOL)
            np.testing.assert_allclose(got, o["ref_loss"], rtol=F32_TOL)
            assert got == r[aid]["remat"][False]["loss"]
        np.testing.assert_allclose(r[aid]["plain"]["loss"], o["loss"],
                                   rtol=F32_TOL)
        assert r[aid]["remat"][True]["loss"] == ranks[0][aid]["remat"][
            True]["loss"]


@pytest.mark.parametrize("aid", SPLIT)
def test_split_gradients_match_one_process_and_the_plain_route(split, aid):
    """Every leaf gathered back within F32_TOL of its largest, against one
    process and the unsplit route; the three remats bit for bit; the grad
    norm counting each element once."""
    ranks, one = split
    o = one[aid]
    want_norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in
                                     _tree.tree_leaves(o["grads"]))))
    for r in ranks:
        res = r[aid]
        got = res["remat"][True]["grads"]
        for want in (o["grads"], res["plain"]["grads"]):
            errs = _leaf_errs(got, want)
            assert max(errs.values()) <= F32_TOL, sorted(
                errs.items(), key=lambda kv: -kv[1])[:3]
        for remat in ("names", False):
            assert all(torch.equal(a, b) for a, b in zip(
                _tree.tree_leaves(res["remat"][remat]["grads"]),
                _tree.tree_leaves(got)))
        np.testing.assert_allclose(res["remat"][True]["grad_norm"],
                                   want_norm, rtol=F32_TOL)
        np.testing.assert_allclose(res["plain"]["grad_norm"], want_norm,
                                   rtol=F32_TOL)


@pytest.mark.parametrize("aid", SPLIT)
def test_split_train_step_is_adamw_of_the_split_gradient(split, aid):
    """``make_sharded_train_step(split_model=True)``: its update is AdamW
    of the split gradient, clipped by its norm, bit for bit; its loss and
    norm those of the split gradient (the norm within F32_TOL of the
    unsplit route's)."""
    ranks, _ = split
    for r in ranks:
        got = r[aid]["step"]
        assert got["equal"]
        assert got["loss"] == r[aid]["remat"][True]["loss"]
        assert got["grad_norm"] == r[aid]["remat"][True]["grad_norm"]
        np.testing.assert_allclose(got["grad_norm"],
                                   r[aid]["plain"]["grad_norm"],
                                   rtol=F32_TOL)


@pytest.mark.parametrize("aid", SPLIT)
def test_norm_gradients_and_moe_routes_equal_across_model_ranks(split,
                                                                 aid):
    """The replicated norms' gradients, and every MoE route (and its
    recomputation under remat), equal on the model ranks of a data
    shard."""
    ranks, one = split
    by_data = {}
    for r in ranks:
        by_data.setdefault(r["coords"]["data"], []).append(r[aid])
    for pair in by_data.values():
        for remat in REMATS:
            a, b = (p["remat"][remat] for p in pair)
            assert a["norms"] and a["norms"].keys() == b["norms"].keys()
            assert all(torch.equal(a["norms"][n], b["norms"][n])
                       for n in a["norms"])
            assert len(a["routes"]) == len(b["routes"])
            for ra, rb in zip(a["routes"], b["routes"]):
                assert all(torch.equal(x, y) for x, y in zip(ra, rb))
    if one[aid]["cfg"].moe is None:
        return
    res = ranks[0][aid]["remat"]
    n = len(res[False]["routes"])
    assert n == one[aid]["cfg"].n_layers
    # remat=True routes each layer again in the recomputation: the same
    assert len(res[True]["routes"]) == 2 * n
    for first, again in zip(res[True]["routes"][:n], res[True]["routes"][n:]):
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("aid", SPLIT)
def test_serve_prefill_and_decode_match_one_process(split, aid):
    ranks, one = split
    o = one[aid]
    got = _assemble(ranks, lambda r: r[aid]["prefill"])
    want = o["prefill"].flatten(2)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= SERVE_TOL * float(
        want.abs().max())
    assert len(o["decode"]) == _steps(aid)
    for t in range(_steps(aid)):
        got = _assemble(ranks, lambda r: r[aid]["decode"][t])
        want = o["decode"][t].flatten(2)
        assert float((got - want).abs().max()) <= SERVE_TOL * float(
            want.abs().max())


@pytest.mark.parametrize("aid", SPLIT)
def test_split_wire_bytes_equal_step_wire_bytes(split, aid):
    """Each rank's counted bytes equal the plan exactly, at each remat;
    the model axis runs as many more all-reduces under "names" than under
    False as its mixers run inside their spans (mLSTM's gate sum), and
    under True the forward's again."""
    ranks, one = split
    cfg = one[aid]["cfg"]
    mesh = shd.MeshShape.of(*MESH)
    shape = ShapeConfig("tp", SS, SB, "train")
    for r in ranks:
        calls = {}
        for remat in REMATS:
            want = roofline.step_wire_bytes(cfg, shape, mesh,
                                            split_model=True, remat=remat)
            wire = r[aid]["remat"][remat]["wire"]
            for a in want:
                for kind in want[a]:
                    assert wire[a][0][kind] == want[a][kind], (remat, a, kind)
                assert wire[a][0]["collective-permute"] == 0.0
            calls[remat] = wire["model"][1]["all-reduce"]
        assert calls[False] < calls[True]
    pattern = cfg.pattern_for_layers() * cfg.n_groups
    spans = pattern.count("mlstm")
    fwd = sum(1 + int(tt.block_has_ffn(cfg, kind)) for kind in pattern)
    plain = roofline.step_wire_bytes(cfg, shape, mesh)
    split_ = roofline.step_wire_bytes(cfg, shape, mesh, split_model=True)
    assert split_["data"]["all-gather"] < plain["data"]["all-gather"]
    assert calls["names"] - calls[False] == spans
    assert calls[True] - calls[False] == fwd + spans


@pytest.mark.parametrize("aid", SPLIT)
def test_serve_wire_bytes_equal_step_wire_bytes(split, aid):
    """The prefill's and each decode step's counted bytes (the data-axis
    gathers of the blocks, the embedding's gather and the forward's
    reduces over "model") equal the plan exactly."""
    ranks, one = split
    cfg = one[aid]["cfg"]
    mesh = shd.MeshShape.of(*MESH)
    plans = {kind: roofline.step_wire_bytes(
        cfg, ShapeConfig(kind, SS, SB, kind), mesh, split_model=True)
        for kind in ("prefill", "decode")}
    assert plans["prefill"]["model"]["all-reduce"] > 0
    for r in ranks:
        for kind, wires in (("prefill", [r[aid]["prefill_wire"]]),
                            ("decode", r[aid]["decode_wire"])):
            for wire in wires:
                for a, want in plans[kind].items():
                    for k in want:
                        assert wire[a][0][k] == want[k], (kind, a, k)


@pytest.mark.parametrize("case", QUAD)
def test_split_on_a_model_axis_of_4(split, case):
    """QUAD on (1, 4). kv_heads: qwen2-7b's 2 kv heads over 4, each rank's
    query head reading its kv head gathered whole, the decode cache cut by
    length (4 of 16 slots a rank, three ranks empty at the first step).
    whole_ffn: xlstm's sLSTM FFN leaves stored whole over "model", each
    rank reading its part (their gradients summed). codebook_cut:
    musicgen's 2 codebooks over 4, each rank's head columns half a
    codebook's vocabulary (its logits (b, s, K V / 4)), the per-codebook
    loss reduced over the two ranks that hold it. The loss (and the
    reference's), the gradients, the prefill and the decode against one
    process, the wire bytes against the plan."""
    ranks, one = split
    o = one[case]
    cfg = o["cfg"]
    mesh = shd.MeshShape.of(*KV_MESH)
    specs = shd.param_specs(tt.init_params(None, cfg, device="meta"), cfg,
                            mesh)
    plans = {kind: roofline.step_wire_bytes(
        cfg, ShapeConfig(kind, SS, SB, kind), mesh, split_model=True)
        for kind in ("train", "prefill", "decode")}
    if case in ("kv_heads", "codebook_cut"):
        assert plans["decode"]["model"]["all-gather"] > plans["decode"][
            "data"]["all-gather"] == 0
    if case == "whole_ffn":
        blk = specs["groups"]["blk1_slstm"]["mixer"]
        assert not shd.has_model(blk["w_ffn_up"])
        assert not shd.has_model(blk["w_ffn_down"])
    if case == "codebook_cut":
        v = cfg.vocab_size
        assert [shd.model_view(cfg, mesh, m).vocab for m in range(4)] == [
            (0, v // 2), (v // 2, v), (v, 3 * v // 2), (3 * v // 2, 2 * v)]
    want_norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in
                                     _tree.tree_leaves(o["grads"]))))
    res = [r["quad"][case] for r in ranks]
    assert sorted(r["coords"]["model"] for r in res) == [0, 1, 2, 3]
    for r in res:
        if case != "whole_ffn":
            assert r["cache_shapes"]["blk0_attn/k"] == (
                cfg.n_groups, SB, cfg.n_kv_heads, SS // 4, cfg.hd)
            np.testing.assert_allclose(r["loss"], o["ref_loss"],
                                       rtol=F32_TOL)
        np.testing.assert_allclose(r["loss"], o["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(r["grad_norm"], want_norm, rtol=F32_TOL)
        errs = _leaf_errs(r["grads"], o["grads"])
        assert max(errs.values()) <= F32_TOL, sorted(
            errs.items(), key=lambda kv: -kv[1])[:3]
        for kind, wires in (("train", [r["wire"]]),
                            ("prefill", [r["prefill_wire"]]),
                            ("decode", r["decode_wire"])):
            for wire in wires:
                for a, want in plans[kind].items():
                    for k in want:
                        assert wire[a][0][k] == want[k], (kind, a, k)
    by_model = sorted(res, key=lambda r: r["coords"]["model"])
    got = torch.cat([r["prefill"].flatten(2) for r in by_model], -1)
    want = o["prefill"].flatten(2)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= SERVE_TOL * float(
        want.abs().max())
    assert len(o["decode"]) == len(res[0]["decode"])
    for t in range(len(o["decode"])):
        got = torch.cat([r["decode"][t].flatten(2) for r in by_model], -1)
        want = o["decode"][t].flatten(2)
        assert float((got - want).abs().max()) <= SERVE_TOL * float(
            want.abs().max())


@pytest.mark.parametrize("route", ["summed", "plain"])
def test_gather_summed_gradient_is_the_unsplit_gradient(split, route):
    """``gather_summed_from_model``'s gradient is the unsplit one (each
    rank's consumer of the gathered whole differs); ``gather_from_model``
    in its place gives each rank only its own consumer's share, off by
    about half: the check that would catch it."""
    ranks, _ = split
    for r in ranks:
        c = r["collective"]
        assert c["whole_equal"]
        err = float((c[route] - c["want"]).abs().max())
        if route == "summed":
            assert err <= F32_TOL * float(c["want"].abs().max())
        else:
            assert err > 0.3 * float(c["want"].abs().max())


def test_partial_product_is_the_f32_product_of_bf16_parts():
    """``partial_product`` of bf16 blocks under a split: the f32 product
    of the bf16 values (unrounded, for the f32 sum over "model"), with the
    gradients of the bf16 ``a @ w``; unsplit or in f32, ``a @ w`` itself."""
    from repro_torch.launch.mesh import partial_product
    gen = torch.Generator().manual_seed(5)
    a32, w32 = torch.randn(3, 5, 16, generator=gen), torch.randn(
        16, 8, generator=gen)
    a, w = a32.bfloat16().requires_grad_(), w32.bfloat16().requires_grad_()
    got = partial_product(a, w, _Axis(2))
    assert got.dtype == torch.float32
    assert torch.equal(got, a.detach().float() @ w.detach().float())
    g = torch.randn(got.shape, generator=gen)
    ga, gw = torch.autograd.grad(got, (a, w), g)
    a2, w2 = a.detach().requires_grad_(), w.detach().requires_grad_()
    wa, ww = torch.autograd.grad(a2 @ w2, (a2, w2), g.bfloat16())
    assert ga.dtype == torch.bfloat16 and torch.equal(ga, wa)
    assert torch.equal(gw, ww)
    assert partial_product(a, w, None).dtype == torch.bfloat16
    assert torch.equal(partial_product(a32, w32, _Axis(2)), a32 @ w32)


def test_make_mesh_over_some_ranks(split):
    """``make_mesh(..., ranks=)`` lays out only the given global ranks
    (the others get ``None``), and its collectives run over them alone."""
    ranks, _ = split
    subs = {r["coords"]["data"] * 2 + r["coords"]["model"]: r["sub"]
            for r in ranks}
    assert subs[0] is None and subs[2] is None
    for g, m in ((1, 0), (3, 1)):
        assert subs[g]["coords"] == {"data": 0, "model": m}
        assert subs[g]["ranks"] == (1, 3) and subs[g]["sum"] == 4.0
        assert torch.equal(subs[g]["scattered"], torch.full((2,), 4.0))


class _Axis:
    """A model axis's size and this rank's index, for planning."""

    def __init__(self, size, index=0):
        self.size, self.index = size, index


@pytest.mark.parametrize("aid", SPLIT + tuple(QUAD) + tuple(HEADS)
                         + tuple(UNEVEN))
def test_decode_state_is_the_dry_run_plan(aid):
    """``init_decode_state(model=)`` allocates exactly the dry run's
    per-rank decode-state plan (``decode_state_specs``) on each model
    rank: the kv heads, or the cache's length where they do not divide,
    and the recurrent states' channels and heads (whole, or a block that
    may end mid-head, where the heads do not divide)."""
    from repro_torch.launch import dryrun
    if aid in HEADS or aid in UNEVEN:
        case = HEADS.get(aid) or UNEVEN[aid]
        cfg, sizes = _cfg(tcfg, case[0], **case[1]), case[2]
    elif aid in QUAD:
        cfg, sizes = _cfg(tcfg, QUAD[aid][0], **QUAD[aid][1]), KV_MESH
    else:
        cfg, sizes = _cfg(tcfg, aid), MESH
    mesh = shd.MeshShape.of(*sizes)
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    plan = dryrun.memory_plan(cfg, ShapeConfig("decode", SS, SB, "decode"),
                              mesh, AdamWConfig())["decode_state"]
    for m in range(tp):
        state = tt.init_decode_state(cfg, SB // dp, SS, device="meta",
                                     model=_Axis(tp, m))
        leaves = [x for x in _tree.tree_leaves(state)
                  if isinstance(x, torch.Tensor)]
        got = sum(x.numel() * x.element_size() for x in leaves)
        assert got == plan["bytes"], (m, got, plan)
        assert sum(dryrun._alloc(x.numel() * x.element_size())
                   for x in leaves) == plan["alloc"]


@pytest.mark.parametrize("aid", SPLIT)
def test_model_view_blocks_are_the_sharded_leaves(aid):
    """The view's head, kv head, FFN, expert, channel, recurrent head and
    vocabulary blocks are the rank's blocks of the leaves after the
    data-axis gather (the kv heads a rank reads, where they do not
    divide)."""
    from repro_torch.models.recurrent import MLSTM_HEAD_DIM
    cfg = _cfg(tcfg, aid)
    mesh = shd.MeshShape.of(*MESH)
    params = tt.init_params(None, cfg, device="meta")
    specs = shd.param_specs(params, cfg, mesh)
    dspecs = shd.data_specs(specs, mesh)
    pattern = cfg.pattern_for_layers()

    def model_block(*path):
        """A leaf's shape after the data-axis gather: cut by "model"."""
        leaf, spec = params, specs
        for k in path:
            leaf, spec = leaf[k], spec[k]
        return shd.local_shape(leaf.shape, tuple(
            "model" if shd.has_model((e,)) else None for e in spec), mesh)

    def width(r):
        return r[1] - r[0]

    cols = cfg.vocab_size * (cfg.n_codebooks if cfg.frontend
                             == "audio_codec" else 1)    # the head's
    for m in range(2):
        view = shd.model_view(cfg, mesh, m)
        assert view.tp == 2 and view.embed_pieces == 2
        assert view.vocab == (m * cols // 2, (m + 1) * cols // 2)
        assert model_block("lm_head")[-1] == width(view.vocab)
        assert model_block("embed")[-1] == cfg.d_model // 2
        for i, kind in enumerate(pattern):
            mixer = ("groups", f"blk{i}_{kind}", "mixer")
            ffn = ("groups", f"blk{i}_{kind}", "ffn")
            if kind in ("attn", "swa"):
                assert view.heads == (m * cfg.n_heads // 2,
                                      (m + 1) * cfg.n_heads // 2)
                assert model_block(*mixer, "wq")[-1] == \
                    width(view.heads) * cfg.hd
                assert model_block(*mixer, "wo")[1] == \
                    width(view.heads) * cfg.hd
                if view.kv_cut:
                    assert model_block(*mixer, "wk")[-1] == \
                        width(view.kv_heads) * cfg.hd
                else:           # a column block of every kv head
                    assert view.kv_heads == shd.kv_read(
                        cfg.n_heads, cfg.n_kv_heads, view.heads)
                    assert model_block(*mixer, "wk")[-1] == \
                        cfg.n_kv_heads * cfg.hd // 2
            elif kind == "rglru":
                assert view.channels == (m * cfg.d_model // 2,
                                         (m + 1) * cfg.d_model // 2)
                for k in ("w_in", "w_gate_in", "w_rgate", "w_igate"):
                    assert model_block(*mixer, k)[-1] == width(view.channels)
                assert model_block(*mixer, "w_out")[1] == \
                    width(view.channels)
            elif kind == "mlstm":
                assert width(view.mlstm_heads) == 2
                for k in ("w_up", "w_gate"):
                    assert model_block(*mixer, k)[-1] == \
                        width(view.mlstm_heads) * MLSTM_HEAD_DIM
                assert model_block(*mixer, "w_q")[1] == \
                    width(view.mlstm_heads)
            elif kind == "slstm":
                assert width(view.slstm_heads) == 1
                assert model_block(*mixer, "r_gates")[1] == 1
                # gate-major: a rank stores two of the four gates
                assert model_block(*mixer, "w_gates")[-1] == 2 * cfg.d_model
            if not tt.block_has_ffn(cfg, kind):
                continue
            if cfg.moe is None:
                assert model_block(*ffn, "w_up")[-1] == width(view.ffn_cols)
                assert view.experts is None
            else:
                assert view.experts == (m * cfg.moe.n_experts // 2,
                                        (m + 1) * cfg.moe.n_experts // 2)
                assert model_block(*ffn, "w_up")[1] == width(view.experts)
    assert dspecs["embed"][-1] == "data" and not any(dspecs["embed"][:-1])
    assert dspecs["lm_head"] == ("data", None)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("aid", tcfg.ARCH_IDS)
def test_model_view_admits_every_architecture_on_production_meshes(
        aid, multi_pod):
    """``model_view`` admits all ten registered architectures on the
    reference's production meshes, (16, 16) and (2, 16, 16): on the 16
    model ranks the query, mLSTM and sLSTM heads' shares partition [0, n)
    in axis order, as even as whole heads allow (the larger first); each
    rank's kv heads are its own block where they divide, else
    ``kv_read`` of its heads; ``q_cols`` / ``mlstm_cols`` / ``slstm_cols``
    are wq's, w_up's and w_gates' stored column blocks. A tied head is
    admitted with the same vocabulary blocks, the embedding cut over
    "model" (its rows come by an all-to-all); the audio frontend's raises
    ``ValueError``."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.recurrent import _slstm_hd, mlstm_heads
    cfg = tcfg.get_arch(aid)
    mesh = make_production_mesh(multi_pod=multi_pod)
    tp = mesh.shape["model"]
    views = [shd.model_view(cfg, mesh, m) for m in range(tp)]
    kinds = set(cfg.pattern_for_layers())
    counts = {"heads": cfg.n_heads if kinds & {"attn", "swa"} else None,
              "mlstm_heads": mlstm_heads(cfg) if "mlstm" in kinds else None,
              "slstm_heads": (cfg.d_model // _slstm_hd(cfg.d_model)
                              if "slstm" in kinds else None)}
    for field, n in counts.items():
        spans = [getattr(v, field) for v in views]
        if n is None:
            assert all(sp is None for sp in spans)
            continue
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        sizes = [hi - lo for lo, hi in spans]
        assert sizes == sorted(sizes, reverse=True) and sizes[0] - sizes[
            -1] <= 1 and sum(sizes) == n
    for m, v in enumerate(views):
        if counts["mlstm_heads"]:       # w_up's 2 d and w_gates' 4 d columns
            assert v.mlstm_cols == (m * 2 * cfg.d_model // tp,
                                    (m + 1) * 2 * cfg.d_model // tp)
            assert v.slstm_cols == (m * 4 * cfg.d_model // tp,
                                    (m + 1) * 4 * cfg.d_model // tp)
        if v.heads is None:
            continue
        cols = cfg.n_heads * cfg.hd // tp
        assert v.q_cols == (m * cols, (m + 1) * cols)
        if v.kv_cut:
            per = cfg.n_kv_heads // tp
            assert v.kv_heads == (m * per, (m + 1) * per)
        else:
            assert v.kv_heads == shd.kv_read(cfg.n_heads, cfg.n_kv_heads,
                                             v.heads)
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    if cfg.frontend == "audio_codec":
        with pytest.raises(ValueError, match="audio_codec"):
            shd.model_view(tied, mesh)
        return
    for m in range(tp):
        v = shd.model_view(tied, mesh, m)
        assert v.vocab == views[m].vocab and v.embed_cut and not v.whole


@pytest.mark.parametrize("n,tp", [(28, 16), (10, 16), (8, 16), (24, 16),
                                  (6, 4), (2, 4), (3, 2), (32, 16)])
def test_share_partitions_whole_heads(n, tp):
    """``sharding.share``: the first n % tp ranks take one more head, the
    rest n // tp (none where n < tp); ``_block`` where tp divides n;
    ``kv_read`` of an empty share is empty."""
    spans = [shd.share(n, tp, m) for m in range(tp)]
    assert [hi - lo for lo, hi in spans] == [
        n // tp + int(m < n % tp) for m in range(tp)]
    assert spans[0][0] == 0 and spans[-1][1] == n and all(
        a[1] == b[0] for a, b in zip(spans, spans[1:]))
    if n % tp == 0:
        assert spans == [shd._block(n, tp, m) for m in range(tp)]
    for lo, hi in spans:
        kv = shd.kv_read(n, 1, (lo, hi))
        assert kv == ((0, 1) if hi > lo else (kv[0], kv[0]))


@pytest.mark.parametrize("aid", ("qwen2-7b", "recurrentgemma-2b",
                                 "paligemma-3b", "musicgen-medium"))
def test_roofline_plans_heads_that_do_not_divide(aid):
    """``roofline.run_cell(split_model=True)`` plans prefill_32k on (16, 16)
    for the four families whose query heads do not divide over 16: the
    model axis carries the q gathers and the output regroups
    (reduce-scatters), the FLOPs a rank a sixteenth of a batch shard's."""
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    cfg = tcfg.get_arch(aid)
    assert cfg.n_heads % mesh.shape["model"]
    res = roofline.run_cell(aid, "prefill_32k", mesh=mesh, split_model=True)
    plain = roofline.run_cell(aid, "prefill_32k", mesh=mesh)
    assert res["roofline"]["bound_s"] > 0
    assert res["wire_by_axis"]["model"]["reduce-scatter"] > 0
    assert res["wire_by_axis"]["model"]["all-gather"] > 0
    np.testing.assert_allclose(res["flops_per_dev"] * 16,
                               plain["flops_per_dev"], rtol=1e-12)


def _fake_mesh(sizes):
    names = tuple(a for a, _ in sizes)
    return Mesh(names, dict(sizes), dict.fromkeys(names, 0), {},
                torch.device("cpu"), "gloo")


def test_split_refuses_a_tied_audio_head():
    """A tied head with the audio frontend (musicgen) has no meaning (the
    reference's logits are ``None`` there): the train step and the serve
    step raise ``ValueError`` naming it."""
    from repro_torch.train.step import (make_sharded_serve_step,
                                        make_sharded_train_step)
    cfg = dataclasses.replace(_cfg(tcfg, "musicgen-medium"),
                              tie_embeddings=True)
    with pytest.raises(ValueError, match="audio_codec"):
        make_sharded_train_step(cfg, AdamWConfig(), _fake_mesh(KV_MESH),
                                global_batch=SB, split_model=True)
    with pytest.raises(ValueError, match="audio_codec"):
        make_sharded_serve_step(cfg, _fake_mesh(KV_MESH), SB)


@pytest.mark.parametrize("case", UNEVEN)
def test_uneven_split_trains_as_one_process_and_reference(split, case):
    """UNEVEN: the split loss against one process's and the reference's,
    every gradient leaf gathered back against one process's and
    ``jax.value_and_grad`` of the reference's loss (the tied ``embed``
    carrying the lookup's and the head's), the grad norm, at remat
    True."""
    ranks, one = split
    o = one[case]
    np.testing.assert_allclose(o["loss"], o["ref_loss"], rtol=F32_TOL)
    errs = _leaf_errs(o["grads"], o["ref_grads"])
    assert max(errs.values()) <= F32_TOL, errs
    want_norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in
                                     _tree.tree_leaves(o["grads"]))))
    for r in (r["uneven"][case] for r in ranks):
        np.testing.assert_allclose(r["loss"], o["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(r["loss"], o["ref_loss"], rtol=F32_TOL)
        np.testing.assert_allclose(r["grad_norm"], want_norm, rtol=F32_TOL)
        for want in (o["grads"], o["ref_grads"]):
            errs = _leaf_errs(r["grads"], want)
            assert max(errs.values()) <= F32_TOL, sorted(
                errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("case", UNEVEN)
def test_uneven_split_serves_as_one_process(split, case):
    """UNEVEN: the prefill's and every decode step's logits, each rank's
    vocabulary block put together, against one process (a tied head's
    decode through the reduce-scatter of f32 parts)."""
    ranks, one = split
    o = one[case]
    res = [r["uneven"][case] for r in ranks]
    got = _by_coords(res, lambda r: r["prefill"])
    want = o["prefill"].flatten(2)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= SERVE_TOL * float(
        want.abs().max())
    assert len(o["decode"]) == len(res[0]["decode"])
    for t, want in enumerate(o["decode"]):
        got = _by_coords(res, lambda r: r["decode"][t])
        assert float((got - want.flatten(2)).abs().max()) <= \
            SERVE_TOL * float(want.abs().max())


@pytest.mark.parametrize("case", UNEVEN)
def test_uneven_split_bytes_equal_the_plan(split, case):
    """UNEVEN: the wire bytes of the train step, the prefill and each
    decode step equal ``step_wire_bytes`` exactly (a tied head's
    all-to-alls, or a whole table's gathered gradient; a whole mixer's
    leaf gathers), the decode state's bytes the dry run's plan (a whole
    mixer's state whole on every rank); ``model_view`` admits the
    configuration, the whole mixers named."""
    from repro_torch.launch import dryrun
    ranks, one = split
    cfg = one[case]["cfg"]
    mesh = shd.MeshShape.of(*UNEVEN[case][2])
    tp = mesh.shape["model"]
    views = [shd.model_view(cfg, mesh, m) for m in range(tp)]
    kinds = set(cfg.pattern_for_layers()) & {"rglru", "slstm"}
    assert all(v.whole == tuple(sorted(kinds, key=("rglru", "slstm").index))
               for v in views)
    assert all(v.embed_cut == (cfg.d_model % tp == 0) for v in views)
    plans = {kind: roofline.step_wire_bytes(
        cfg, ShapeConfig(kind, SS, SB, kind), mesh, split_model=True)
        for kind in ("train", "prefill", "decode")}
    if case in ("tied", "tied_quad"):
        assert plans["train"]["model"]["all-to-all"] == 2 * plans[
            "prefill"]["model"]["all-to-all"] > 0
        assert plans["decode"]["model"]["all-to-all"] == 0
        assert plans["decode"]["model"]["reduce-scatter"] > 0
    state = dryrun.memory_plan(cfg, ShapeConfig("decode", SS, SB, "decode"),
                               mesh, AdamWConfig())["decode_state"]
    for r in (r["uneven"][case] for r in ranks):
        for kind, wires in (("train", [r["wire"]]),
                            ("prefill", [r["prefill_wire"]]),
                            ("decode", r["decode_wire"])):
            for wire in wires:
                for a, want in plans[kind].items():
                    for k in want:
                        assert wire[a][0][k] == want[k], (kind, a, k)
                    assert wire[a][0]["collective-permute"] == 0.0
        assert r["state_bytes"] == state["bytes"]


def _by_coords(res, key):
    """The global (b, s, C) logits from each rank's block (``_assemble``'s
    layout), ``res`` a rank's HEADS result."""
    rows = {}
    for r in res:
        rows.setdefault(r["coords"]["data"], {})[r["coords"]["model"]] = \
            key(r).flatten(2)
    return torch.cat([torch.cat([rows[d][m] for m in sorted(rows[d])], -1)
                      for d in sorted(rows)], 0)


@pytest.mark.parametrize("case", HEADS)
def test_heads_that_do_not_divide_train_as_one_process(split, case):
    """HEADS: the split loss (and, for recurrentgemma and qwen2, the
    reference's), every gradient leaf gathered back and the grad norm
    against one process, at remat True."""
    ranks, one = split
    o = one[case]
    want_norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in
                                     _tree.tree_leaves(o["grads"]))))
    if case in HEADS_REF:
        np.testing.assert_allclose(o["loss"], o["ref_loss"], rtol=F32_TOL)
    for r in (r["heads"][case] for r in ranks):
        np.testing.assert_allclose(r["loss"], o["loss"], rtol=F32_TOL)
        if case in HEADS_REF:
            np.testing.assert_allclose(r["loss"], o["ref_loss"], rtol=F32_TOL)
        np.testing.assert_allclose(r["grad_norm"], want_norm, rtol=F32_TOL)
        errs = _leaf_errs(r["grads"], o["grads"])
        assert max(errs.values()) <= F32_TOL, sorted(
            errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("case", HEADS)
def test_heads_that_do_not_divide_serve_as_one_process(split, case):
    """HEADS: the prefill's and every decode step's logits, each rank's
    block put together, against one process; each rank's prefill calls the
    kernel once an attention layer on its own heads, a rank with none not
    at all."""
    ranks, one = split
    o = one[case]
    cfg = o["cfg"]
    res = [r["heads"][case] for r in ranks]
    got = _by_coords(res, lambda r: r["prefill"])
    want = o["prefill"].flatten(2)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= SERVE_TOL * float(
        want.abs().max())
    assert len(o["decode"]) == len(res[0]["decode"]) == _steps(
        HEADS[case][0])
    for t, want in enumerate(o["decode"]):
        got = _by_coords(res, lambda r: r["decode"][t])
        assert float((got - want.flatten(2)).abs().max()) <= \
            SERVE_TOL * float(want.abs().max())
    mesh = shd.MeshShape.of(*HEADS[case][2])
    n_attn = sum(k in ("attn", "swa") for k in cfg.pattern_for_layers()
                 ) * cfg.n_groups
    for r in res:
        view = shd.model_view(cfg, mesh, r["coords"]["model"])
        nq = 0 if view.heads is None else view.heads[1] - view.heads[0]
        assert r["flash_calls"] == ([nq] * n_attn if nq else [])


@pytest.mark.parametrize("case", HEADS)
def test_heads_that_do_not_divide_bytes_equal_the_plan(split, case):
    """HEADS: the wire bytes of the train step (remat True), the prefill
    and each decode step equal ``step_wire_bytes`` exactly, the model axis
    carrying the new regroups (reduce-scatters forward); the decode state's
    bytes equal the dry run's plan on every rank, the ring cut by length."""
    from repro_torch.launch import dryrun
    ranks, one = split
    cfg = one[case]["cfg"]
    mesh = shd.MeshShape.of(*HEADS[case][2])
    plans = {kind: roofline.step_wire_bytes(
        cfg, ShapeConfig(kind, SS, SB, kind), mesh, split_model=True)
        for kind in ("train", "prefill", "decode")}
    if case != "kv_groups":     # its heads divide: its kv heads gathered
        assert plans["prefill"]["model"]["reduce-scatter"] > 0
    state = dryrun.memory_plan(cfg, ShapeConfig("decode", SS, SB, "decode"),
                               mesh, AdamWConfig())["decode_state"]
    for r in (r["heads"][case] for r in ranks):
        for kind, wires in (("train", [r["wire"]]),
                            ("prefill", [r["prefill_wire"]]),
                            ("decode", r["decode_wire"])):
            for wire in wires:
                for a, want in plans[kind].items():
                    for k in want:
                        assert wire[a][0][k] == want[k], (kind, a, k)
        assert r["state_bytes"] == state["bytes"]
        for name, shp in r["cache_shapes"].items():
            if name.endswith("/k"):
                ring = min(cfg.window, SS) if "_swa/" in name else SS
                assert shp[2:4] == (cfg.n_kv_heads,
                                    ring // mesh.shape["model"])


@pytest.mark.parametrize("aid", LONG)
def test_batch_one_decode_matches_one_process(split, aid):
    """A batch of 1 on (2, 2), whole on every rank: h2o-danube's ring cut
    by length over "data" (its kv heads over "model"), recurrentgemma's
    over ("data", "model"), both past the wrap; xlstm's states whole over
    "data". The logits against one process's, the state's bytes equal to
    the dry run's plan, the wire bytes of each step equal to the plan."""
    from repro_torch.launch import dryrun
    ranks, one = split
    cfg = one[aid]["cfg"]
    max_len, steps = LONG[aid]
    mesh = shd.MeshShape.of(*MESH)
    shape = ShapeConfig("long", max_len, 1, "decode")
    plan = dryrun.memory_plan(cfg, shape, mesh, AdamWConfig())
    wire = roofline.step_wire_bytes(cfg, shape, mesh, split_model=True)
    axes = shd.length_axes(cfg, mesh, 1)
    assert axes == {"h2o-danube-1.8b": ("data",), "xlstm-1.3b": ("data",),
                    "recurrentgemma-2b": ("data", "model")}[aid]
    if aid != "xlstm-1.3b":
        assert wire[shd.axes_name(axes)]["all-gather"] > 0
    for r in ranks:
        res = r["long"][aid]
        assert res["state_bytes"] == plan["decode_state"]["bytes"]
        ring = min(cfg.window or max_len, max_len)
        for name, shp in res["cache_shapes"].items():
            if name.endswith("/k"):
                assert shp[1] == 1 and shp[3] == ring // math.prod(
                    mesh.shape[a] for a in axes)
        for w in res["decode_wire"]:
            for a, want in wire.items():
                for k in want:
                    assert w[a][0][k] == want[k], (a, k)
    for t in range(steps):
        want = one[aid]["long"][t]
        for r in ranks:
            got = r["long"][aid]["decode"][t]
            m = r["coords"]["model"]
            part = want.flatten(2).chunk(2, -1)[m]
            assert float((got.flatten(2) - part).abs().max()) <= \
                SERVE_TOL * float(want.abs().max())


def test_ring_that_does_not_divide_is_whole(split):
    """recurrentgemma with a ring of RING - 1 slots, which does not divide
    over "model" (its one kv head): every rank holds the whole ring, as
    ``decode_state_specs`` plans it, and its decode past the wrap matches
    one process; its steps gather no partials (the plan)."""
    from repro_torch.launch import dryrun
    ranks, one = split
    cfg = one[WHOLE_RING]["cfg"]
    mesh = shd.MeshShape.of(*MESH)
    shape = ShapeConfig("ring", SS, SB, "decode")
    plan = dryrun.memory_plan(cfg, shape, mesh, AdamWConfig())
    wire = roofline.step_wire_bytes(cfg, shape, mesh, split_model=True)
    assert wire["model"]["all-gather"] == roofline.step_wire_bytes(
        cfg, ShapeConfig("ring", SS, SB, "prefill"), mesh,
        split_model=True)["model"]["all-gather"] / SS
    for r in ranks:
        res = r["long"][WHOLE_RING]
        assert res["state_bytes"] == plan["decode_state"]["bytes"]
        assert res["cache_shapes"]["blk2_swa/k"] == (
            cfg.n_groups, SB // 2, cfg.n_kv_heads, RING - 1, cfg.hd)
        for w in res["decode_wire"]:
            for a, want in wire.items():
                for k in want:
                    assert w[a][0][k] == want[k], (a, k)
    for t, want in enumerate(one[WHOLE_RING]["decode"]):
        got = _assemble(ranks, lambda r: r["long"][WHOLE_RING]["decode"][t])
        assert float((got - want).abs().max()) <= SERVE_TOL * float(
            want.abs().max())


def test_long_500k_decode_state_is_the_dry_run_plan():
    """recurrentgemma-2b's long_500k decode state on the production mesh
    (16, 16): a batch of 1, so its one kv head's 2,048-slot ring is cut
    over ("data", "model"), 8 slots a rank; ``init_decode_state`` with the
    (16 x 16)-rank length group allocates exactly the dry run's plan."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    cfg = tcfg.get_arch("recurrentgemma-2b")
    mesh = make_production_mesh()
    shape = SHAPES["long_500k"]
    plan = dryrun.memory_plan(cfg, shape, mesh, AdamWConfig())
    assert shd.length_axes(cfg, mesh, shape.global_batch) == ("data",
                                                               "model")
    for rank in (0, 17, 255):
        state = tt.init_decode_state(
            cfg, shape.global_batch, shape.seq_len, device="meta",
            model=_Axis(16, rank % 16), length=_Axis(256, rank))
        k = state["caches"]["blk2_swa"]["k"]
        assert state["rings"]["blk2_swa"] == cfg.window == 2048
        assert k.shape == (cfg.n_groups, 1, 1, 8, cfg.hd)
        leaves = [x for x in _tree.tree_leaves(state)
                  if isinstance(x, torch.Tensor)]
        assert sum(x.numel() * x.element_size() for x in leaves) == \
            plan["decode_state"]["bytes"]
        assert sum(dryrun._alloc(x.numel() * x.element_size())
                   for x in leaves) == plan["decode_state"]["alloc"]


@pytest.mark.parametrize("case", KV_QUANT)
def test_int8_split_decode_matches_one_process(split, case):
    """The int8 KV cache under the split decode: every step's logits, each
    rank's block put together (a batch of 1: each rank's vocabulary block),
    against one process's decode with the int8 cache, within SERVE_TOL of
    their largest."""
    ranks, one = split
    _, sizes, batch, _, steps = KV_QUANT[case]
    tp = dict(sizes)["model"]
    res = [r["int8"][case] for r in ranks]
    assert len(one[case]["decode"]) == steps
    for t, want in enumerate(one[case]["decode"]):
        scale = SERVE_TOL * float(want.abs().max())
        if batch == 1:
            for r in res:
                part = want.flatten(2).chunk(tp, -1)[r["coords"]["model"]]
                got = r["decode"][t].flatten(2)
                assert float((got - part).abs().max()) <= scale, (t, r[
                    "coords"])
        else:
            got = _by_coords(res, lambda r: r["decode"][t])
            assert got.shape == want.flatten(2).shape
            assert float((got - want.flatten(2)).abs().max()) <= scale, t


@pytest.mark.parametrize("case", KV_QUANT)
def test_int8_split_decode_bytes_equal_the_plan(split, case):
    """The int8 split decode's state, ``k_scale`` / ``v_scale`` included
    (one f32 a (token, kv head), cut as k and v are), equals the dry run's
    plan on every rank, and each step's wire bytes equal
    ``step_wire_bytes``."""
    from repro_torch.launch import dryrun
    ranks, one = split
    _, sizes, batch, max_len, _ = KV_QUANT[case]
    cfg = one[case]["cfg"]
    mesh = shd.MeshShape.of(*sizes)
    shape = ShapeConfig(case, max_len, batch, "decode")
    plan = dryrun.memory_plan(cfg, shape, mesh, AdamWConfig())
    wire = roofline.step_wire_bytes(cfg, shape, mesh, split_model=True)
    for r in (r["int8"][case] for r in ranks):
        assert r["state_bytes"] == plan["decode_state"]["bytes"]
        scales = {n: shp for n, shp in r["cache_shapes"].items()
                  if n.endswith("_scale")}
        assert scales
        for name, shp in scales.items():
            k = r["cache_shapes"][name.rsplit("/", 1)[0] + "/k"]
            assert shp == k[:-1] + (1,), name
        for w in r["decode_wire"]:
            for a, want in wire.items():
                for k in want:
                    assert w[a][0][k] == want[k], (a, k)
