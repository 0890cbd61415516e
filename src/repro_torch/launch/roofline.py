"""Roofline terms of a cell on the H100: the twin of
``repro/launch/roofline.py`` and of ``hlo_analysis.roofline_terms``.

The reference compiles each cell for 512 TPU placeholder devices and reads
XLA's ``cost_analysis`` and the collectives of the partitioned HLO. Neither
has a torch meaning. Here the FLOPs and HBM bytes come from
``launch/analytic_cost.py`` (the reference's analytic model, global per
step), divided per rank as the port's step divides them, and the wire bytes
are those the port's step would send, counted with the factors
``launch/mesh.AxisGroup`` counts its collectives by:

  * a rank computes the whole model on its batch shard: FLOPs / the number
    of batch shards (``models/sharding.dp_shards``);
  * it reads every weight (gathered whole) and its shard of the rest:
    weight bytes + the other bytes / the batch shards;
  * it gathers each stored parameter block over the axes its spec names
    (``sharding.gather``), and a train step averages the f32 gradients and
    the loss over the data axes the batch is cut over
    (``train/step.make_sharded_train_step``).

``step_wire_bytes(..., split_model=True)`` counts instead what the step
split over "model" sends: the data-axis gathers of a rank's model blocks
and the split's model-axis collectives.

The train FLOPs and weight reads follow the step's ``remat``
(``analytic_cost``): ``True``, the reference's default, recomputes the
forward once.

Per axis, the "pod" axis's bytes are those that cross pods.

A ``long_500k`` cell of an architecture that is not subquadratic is
skipped (``"status": "skipped"``), as the reference skips it; a cell that
runs has ``"status": "ok"``. ``kv_quant``: the int8 KV cache of
``cfg.kv_quant``; ``analytic_cost`` ignores the flag, as the reference's
does, so a decode cell's kv cache bytes are recounted here as the cache
stores them (``kv_cache_bytes``), the count the reference's XLA bytes
give.

The reference CLI's ``--no-act-constraints`` has no counterpart: the port
pins no activation layout (``models/sharding.activation_specs``).

Usage:
  python -m repro_torch.launch.roofline --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.roofline --arch qwen2-7b --shape train_4k \\
      --multipod --measured-s 12.5 [--remat full|names|none]
  python -m repro_torch.launch.roofline --arch qwen2-7b --shape decode_32k \\
      --mesh-shape 64,4 --kv-quant --split-model [--out FILE]
  python -m repro_torch.launch.roofline --all --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

import numpy as np

from .. import _tree
from ..configs import SHAPES, get_arch, valid_cells
from ..configs.base import ModelConfig, ShapeConfig
from ..models import sharding as shd
from ..models.recurrent import _mlstm_hd, _slstm_hd, mlstm_heads
from ..models.transformer import block_has_ffn, init_params
from .analytic_cost import analytic_cost
from .mesh import WIRE_FACTOR, make_production_mesh

__all__ = ["HW", "roofline_terms", "model_flops", "step_wire_bytes",
           "run_cell", "kv_cache_bytes", "mesh_of", "run_all"]


class HW:
    """NVIDIA H100 SXM5 80 GB, one card: datasheet figures of that card.

    The link figure is NVLink 4's 900 GB/s a card, both directions
    together, so 450 GB/s each way. A machine with one card has no link to
    measure it on; it stays the datasheet's.
    """
    NAME = "NVIDIA H100 SXM5 80GB"
    PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 on the tensor cores
    PEAK_FLOPS_F32 = 67e12         # FLOP/s, f32 on the CUDA cores
    HBM_BW = 3.35e12               # B/s, HBM3
    HBM_BYTES = 80e9               # 80 GB of HBM3
    LINK_BW = 450e9                # B/s each way, NVLink 4


def roofline_terms(*, flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float, hw=HW) -> Dict[str, Any]:
    """The three per-step time lower bounds (seconds), per device."""
    t_compute = flops_per_dev / hw.PEAK_FLOPS_BF16
    t_memory = bytes_per_dev / hw.HBM_BW
    t_collective = wire_bytes_per_dev / hw.LINK_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory),
        ("collective", t_collective), key=lambda kv: kv[1])[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_collective),
    }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 N D (train) / 2 N D (prefill and decode), N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch     # one token per sequence


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _mixer_collectives(cfg: ModelConfig, kind: str, mixer_specs,
                       rows: int, tp: int, decode: bool = False):
    """The model-axis collectives inside one split block's mixer span, a
    forward's: (all-gather result bytes, all-reduce payload elements,
    reduce-scatter input bytes), each a list. In a train step's backward
    each gather's gradient is reduce-scattered (the same bytes), each
    all-reduce's all-reduced (f32 forward, the model's dtype backward) and
    each reduce-scatter's all-gathered; a prefill's and a decode's run
    forward only. ``rows``: the rank's b s (b at decode). Where heads do
    not divide over "model" (``sharding.share``), the regroups between a
    stored block and the rank's heads (``launch/mesh.take_share`` /
    ``put_share``): attention's q gathered whole and its heads' output
    reduce-scattered to ``wo``'s block, mLSTM's ``u`` likewise and its
    output, sLSTM's ``h`` reduce-scattered before its gather, and at
    decode the recurrent states' (sLSTM's channel blocks: gathered and
    reduce-scattered, f32; mLSTM's, kept whole: an f32 all-reduce). Decode
    by length's collectives, and at decode attention's q gather, are
    ``_decode_collectives'``."""
    dt = cfg.torch_dtype.itemsize
    d = cfg.d_model
    cut = {k: shd.has_model(v) for k, v in mixer_specs.items()}
    gathers, reduces, scatters = [], [], []
    if kind in ("attn", "swa"):
        q_bytes = rows * cfg.n_heads * cfg.hd * dt
        if cfg.n_heads % tp and cut["wq"] and not decode:
            gathers.append(q_bytes)                     # q gathered whole
        if cfg.n_kv_heads % tp and cut["wk"]:   # k and v gathered whole
            gathers += [rows * cfg.n_kv_heads * cfg.hd * dt] * 2
        if cfg.n_heads % tp and cut["wo"]:
            scatters.append(q_bytes)            # the output to wo's block
    elif kind == "rglru":
        gathers.append(rows * d * 4)                   # the f32 conv
    elif kind == "mlstm":
        h = mlstm_heads(cfg)
        if cut["w_if"]:
            gathers.append(2 * d * 2 * h * dt)          # w_if, whole
        reduces.append(rows * 2 * h)                    # the gates
        if h % tp:
            gathers.append(rows * 2 * d * dt)           # u to the heads
            scatters.append(rows * 2 * d * dt)          # back to the block
            if decode:                                  # the whole (c, n)
                hd = _mlstm_hd(cfg)
                reduces.append(rows * h * (hd * hd + hd))
    elif kind == "slstm":
        f_up = 4 * d // 3
        if cut["w_gates"]:
            gathers.append(rows * 4 * d * dt)
        gathers.append(rows * d * dt)                   # h into the FFN
        if (d // _slstm_hd(d)) % tp:
            scatters.append(rows * d * dt)              # h to the block
            if decode:                                  # (c, n, h) blocks
                gathers += [rows * d * 4] * 3
                scatters += [rows * d * 4] * 3
        if cut["w_ffn_up"]:
            gathers.append(rows * 2 * f_up * dt)
    return gathers, reduces, scatters


def _whole_mixer_gathers(mixer_specs, params) -> list:
    """The result bytes of the model-axis gathers that make a whole mixer's
    leaves whole (``models/transformer._whole_leaves``: each leaf
    ``param_specs`` cuts over "model" anyway, a group's slice of it). Their
    gradients come back as a slice: no collective."""
    return [float(np.prod(params[k].shape[1:])) * params[k].element_size()
            for k, spec in mixer_specs.items() if shd.has_model(spec)]


def _tied_head_collectives(cfg: ModelConfig, shape: ShapeConfig,
                           embed_spec, rows: int, tp: int):
    """The model-axis collectives of a tied head split over "model"
    (``models/transformer._tied_logits``), as (kind, bytes) a forward and
    (kind, bytes) its backward in a train step: with the embedding cut
    over "model", an all-to-all of the rank's V D / tp block forward and
    of its gradient back (train, prefill), or a decode step's f32
    reduce-scatter of b V parts; with the table whole, a slice forward and
    the gathered gradient back (V D)."""
    dt = cfg.torch_dtype.itemsize
    table = float(cfg.vocab_size * cfg.d_model * dt)
    if not shd.has_model(embed_spec):
        return [], [("all-gather", table)]
    if shape.kind == "decode":
        return [("reduce-scatter", rows * cfg.vocab_size * 4.0)], []
    return [("all-to-all", table / tp)], [("all-to-all", table / tp)]


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The bytes of a decode cell's kv caches as ``init_decode_state``
    stores them (``models/attention.init_kv_cache``), global: every
    attention block's ring (``swa``: of the window) of k and v, in the
    model's dtype, or with ``cfg.kv_quant`` 1 byte an element and an f32
    scale a (token, kv head) for each."""
    per = cfg.n_kv_heads * shape.global_batch * (
        (cfg.hd + 4) if cfg.kv_quant else cfg.hd * cfg.torch_dtype.itemsize)
    total = 0.0
    for kind in cfg.pattern_for_layers():
        if kind in ("attn", "swa"):
            ring = (min(cfg.window or shape.seq_len, shape.seq_len)
                    if kind == "swa" else shape.seq_len)
            total += 2 * per * ring
    return total * cfg.n_groups


def _decode_collectives(cfg: ModelConfig, shape: ShapeConfig,
                        mesh: shd.MeshShape, rows: int):
    """A decode step's all-gathers of attention (``models/attention.py``;
    ``decode_state_specs`` cuts the caches over ``sharding.length_axes``),
    as (group name, its ranks, result bytes): where the kv heads do not
    divide over "model", q gathered over it (of every query head where the
    ring is cut by length, else of the rank's where the query heads do
    not divide either); and for each block whose ring divides over the
    group (a whole ring has none) every rank's partials (max, sum,
    weighted v: hd + 2 f32 a query head) over the group, of every head
    where the kv heads do not divide over "model", else of the rank's."""
    axes = shd.length_axes(cfg, mesh, shape.global_batch)
    n = int(np.prod([mesh.shape[a] for a in axes]))
    tp = mesh.shape.get("model", 1)
    whole = cfg.n_kv_heads % tp != 0
    heads = cfg.n_heads if whole else cfg.n_heads // tp
    out = []
    for kind in cfg.pattern_for_layers():
        if kind not in ("attn", "swa"):
            continue
        ring = (min(cfg.window or shape.seq_len, shape.seq_len)
                if kind == "swa" else shape.seq_len)
        cut = n > 1 and ring % n == 0
        if whole and (cut or cfg.n_heads % tp):
            out.append(("model", tp, rows * cfg.n_heads * cfg.hd
                        * cfg.torch_dtype.itemsize))
        if cut:
            out.append((shd.axes_name(axes), n,
                        n * rows * heads * (cfg.hd + 2) * 4))
    return out


def step_wire_bytes(cfg: ModelConfig, shape: ShapeConfig,
                    mesh: shd.MeshShape, *, split_model: bool = False,
                    remat=True) -> Dict[str, Dict[str, float]]:
    """axis -> kind -> the bytes one rank's step sends: the all-gathers of
    its parameter blocks (in ``sharding.gather``'s order) and, for a train
    step, the f32 all-reduces of the gradients and the loss over the data
    axes the batch is cut over.

    ``split_model``: the compute split over "model"
    (``make_sharded_train_step(split_model=True)`` and
    ``make_sharded_serve_step``), for the configurations
    ``sharding.model_view`` admits (it raises for the others). The blocks
    are gathered over the data axes only and the data-axis gradient is a
    rank's model blocks. On "model", with a = b s D bytes of the rank's
    activations (b its batch shard, the model's dtype): the embedding's
    one all-gather of a (audio: of the K lookups' sum); a forward
    all-reduce after each mixer and each FFN, in f32 (b s D 4 bytes: the
    parts of ``launch/mesh.partial_product``), under ``remat=True`` again;
    in the backward one of a for each (the gradients into the
    column-parallel spans) and one more into the head's; the loss's three
    f32 all-reduces of b s K (max, sum of exponentials, gold logit; K
    codebooks for audio, else 1); the f32 sum of the gradients each rank
    holds a part of (``sharding.partial_over_model``) and of the norm's 4
    bytes. A tied head's (``_tied_head_collectives``). A mixer every rank
    computes whole (``sharding.whole_mixers``) has no reduce and no
    gradient all-reduce, only the gathers of its leaves cut over "model"
    (``_whole_mixer_gathers``), at each run. Inside the mixers
    (``_mixer_collectives``): RG-LRU's f32 conv gather, mLSTM's ``w_if``
    gather and gate all-reduce, sLSTM's gate, ``h`` and FFN gathers, where
    the kv heads do not divide, the k and v gathers, and where the query,
    mLSTM or sLSTM heads do not, the
    regroups between stored blocks and a rank's heads; a train step
    reduce-scatters each gather's gradient, all-gathers each
    reduce-scatter's and all-reduces the gate sum's, and recomputes them
    under both ``remat=True`` and ``"names"`` (they lie inside the
    ``"names"`` spans). At decode, attention's q gathers and by length
    its partials' (``_decode_collectives``), on the group of
    ``sharding.length_axes``.

    The result has an entry for each axis and for each group over a tuple
    of axes (``sharding.group_axes``), as ``launch/mesh.Mesh.wire_bytes``
    counts them."""
    sizes = mesh.shape
    out = {a: {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0,
               "all-to-all": 0.0}
           for a in list(sizes) + [shd.axes_name(t)
                                   for t in shd.group_axes(mesh)]}
    params = init_params(None, cfg, device="meta")
    spec_tree = shd.param_specs(params, cfg, mesh)
    names, leaves, _ = _tree.flatten_with_names(params)
    specs = shd.spec_leaves(spec_tree)
    ar, ag = WIRE_FACTOR["all-reduce"], WIRE_FACTOR["all-gather"]
    rs = WIRE_FACTOR["reduce-scatter"]
    for leaf, spec in zip(leaves, specs):
        nbytes = float(np.prod(shd.local_shape(leaf.shape, spec, mesh))) \
            * leaf.element_size()
        for entry in spec:
            for a in reversed(_axes(entry)):
                if split_model and a == "model":
                    continue
                n = sizes[a]
                out[a]["all-gather"] += ag(n) * n * nbytes
                nbytes *= n
    train = shape.kind == "train"
    dp = shd.dp_shards(cfg, mesh, shape.global_batch)
    tp = sizes.get("model", 1) if split_model else 1
    if train and dp > 1:
        elems = sum(leaf.numel() // (tp if shd.has_model(spec) else 1)
                    for leaf, spec in zip(leaves, specs))
        for a in shd.dp_axes(mesh):
            out[a]["all-reduce"] += ar(sizes[a]) * (4.0 * elems + 4)
    rows = shape.global_batch // dp
    rows *= 1 if shape.kind == "decode" else shape.seq_len
    if split_model and shape.kind == "decode":
        for name, n, nbytes in _decode_collectives(cfg, shape, mesh, rows):
            out[name]["all-gather"] += ag(n) * nbytes * cfg.n_groups
    whole = shd.whole_mixers(cfg, tp)
    if tp > 1:
        dt = cfg.torch_dtype.itemsize
        act = float(rows * cfg.d_model * dt)
        pattern = cfg.pattern_for_layers()
        fwd = sum(int(kind not in whole) + int(block_has_ffn(cfg, kind))
                  for kind in pattern) * cfg.n_groups
        model = out["model"]
        if shd.has_model(spec_tree["embed"]):
            model["all-gather"] += ag(tp) * act
        model["all-reduce"] += ar(tp) * fwd * rows * cfg.d_model * 4.0 * (
            2 if train and remat is True else 1)
        if train:
            model["all-reduce"] += ar(tp) * (fwd + 1) * act
        # a span's collectives: forward, again under either remat, and
        # their gradients' in a train step
        runs = 1 + (int(remat is True or remat == "names") if train else 0)
        factor = {"all-gather": ag, "reduce-scatter": rs,
                  "all-to-all": WIRE_FACTOR["all-to-all"]}
        if cfg.tie_embeddings:
            fwd_c, bwd_c = _tied_head_collectives(cfg, shape,
                                                  spec_tree["embed"], rows,
                                                  tp)
            for kind, nbytes in fwd_c + (bwd_c if train else []):
                model[kind] += factor[kind](tp) * nbytes
        for i, kind in enumerate(pattern):
            mixer = spec_tree["groups"][f"blk{i}_{kind}"]["mixer"]
            if kind in whole:
                for nbytes in _whole_mixer_gathers(
                        mixer, params["groups"][f"blk{i}_{kind}"]["mixer"]):
                    model["all-gather"] += ag(tp) * nbytes * runs \
                        * cfg.n_groups
                continue
            gathers, sums, scatters = _mixer_collectives(
                cfg, kind, mixer, rows, tp, shape.kind == "decode")
            for nbytes in gathers:
                model["all-gather"] += ag(tp) * nbytes * runs * cfg.n_groups
                if train:
                    model["reduce-scatter"] += rs(tp) * nbytes * cfg.n_groups
            for nbytes in scatters:
                model["reduce-scatter"] += rs(tp) * nbytes * runs \
                    * cfg.n_groups
                if train:
                    model["all-gather"] += ag(tp) * nbytes * cfg.n_groups
            for elems in sums:
                model["all-reduce"] += ar(tp) * elems * cfg.n_groups * (
                    4.0 * runs + dt * int(train))
        if train:
            partial = sum(leaf.numel() for n, leaf, spec in
                          zip(names, leaves, specs)
                          if shd.partial_over_model(n, spec, whole))
            n_k = cfg.n_codebooks if cfg.frontend == "audio_codec" else 1
            model["all-reduce"] += ar(tp) * (3 * 4.0 * rows * n_k
                                             + 4.0 * partial + 4)
    return out


def mesh_of(mesh_shape: str) -> shd.MeshShape:
    """A single-pod (data, model) mesh from "d,m", checked as the
    reference checks it: two sizes whose product is 256."""
    dims = tuple(int(t) for t in mesh_shape.split(","))
    if len(dims) != 2 or dims[0] * dims[1] != 256:
        raise ValueError(f"--mesh-shape {mesh_shape!r}: two sizes (data, "
                         f"model) whose product is 256")
    return shd.MeshShape.of(("data", dims[0]), ("model", dims[1]))


def run_cell(arch: str, shape: Union[str, ShapeConfig], *,
             mesh: Optional[shd.MeshShape] = None,
             cfg: Optional[ModelConfig] = None,
             measured_s: Optional[float] = None,
             remat=True, split_model: bool = False,
             kv_quant: bool = False) -> Dict[str, Any]:
    """The three roofline terms of one step of ``arch`` (or ``cfg``, a cut
    of it) at ``shape`` on ``mesh`` (default: the single-pod production
    mesh), per rank, the dominant one, ``bound_s`` and ``mfu_at_bound``;
    with ``measured_s``, the bound's share of that measured step.
    ``long_500k`` on an architecture that is not subquadratic is skipped:
    ``{"arch", "shape", "status": "skipped"}``. ``kv_quant``: the int8 KV
    cache; a decode cell's cache bytes (``kv_cache_bytes``) replace the
    analytic count's kv caches, which is the model dtype's.
    ``remat``: the train step's (``analytic_cost``). ``split_model``: the
    step split over "model" (``step_wire_bytes``'): a rank computes its
    batch shard's FLOPs over its model blocks, FLOPs / (shards x tp), and
    reads its blocks of the weights. It repeats no product: where the kv
    heads do not divide, each rank projects its columns of k and v and
    gathers them; every mixer's gathered input meets only the rank's
    columns. What it repeats is elementwise (norms, the residual stream,
    RoPE on the gathered k, a recurrent gate's slice), which the analytic
    model does not count."""
    cfg = get_arch(arch) if cfg is None else cfg
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if shape.name == "long_500k" and not cfg.subquadratic:
        return {"arch": cfg.name, "shape": shape.name, "status": "skipped"}
    mesh = make_production_mesh() if mesh is None else mesh
    cost = analytic_cost(cfg, shape, remat=remat)
    if shape.kind == "decode" and cfg.kv_quant:
        int8 = kv_cache_bytes(cfg, shape) - kv_cache_bytes(
            dataclasses.replace(cfg, kv_quant=False), shape)
        cost = {**cost, "cache_bytes": cost["cache_bytes"] + int8,
                "hbm_bytes": cost["hbm_bytes"] + int8}
    dp = shd.dp_shards(cfg, mesh, shape.global_batch)
    tp = mesh.shape.get("model", 1) if split_model else 1
    flops_dev = cost["flops"] / (dp * tp)
    bytes_dev = cost["weight_bytes"] / tp + (cost["hbm_bytes"]
                                             - cost["weight_bytes"]) / dp
    wire = step_wire_bytes(cfg, shape, mesh, split_model=split_model,
                           remat=remat)
    wire_dev = sum(sum(kinds.values()) for kinds in wire.values())
    terms = roofline_terms(flops_per_dev=flops_dev, bytes_per_dev=bytes_dev,
                           wire_bytes_per_dev=wire_dev)
    mf = model_flops(cfg, shape)
    res = {
        "arch": cfg.name, "shape": shape.name, "status": "ok",
        "kind": shape.kind, "kv_quant": cfg.kv_quant,
        "cache_bytes": cost["cache_bytes"], "mesh": mesh.shape,
        "n_devices": mesh.size, "batch_shards": dp,
        "remat": remat, "split_model": split_model,
        "flops_per_dev": flops_dev, "bytes_per_dev": bytes_dev,
        "wire_bytes_per_dev": wire_dev, "wire_by_axis": wire,
        "cross_pod_bytes": sum(wire.get("pod", {}).values()),
        "model_flops": mf, "roofline": terms,
        "mfu_at_bound": ((mf / mesh.size / HW.PEAK_FLOPS_BF16)
                         / terms["bound_s"] if terms["bound_s"] else None),
        "hw": HW.NAME,
    }
    if measured_s is not None:
        res["measured_s"] = measured_s
        res["bound_share_of_measured"] = terms["bound_s"] / measured_s
    return res


REMAT_FLAG = {"full": True, "names": "names", "none": False}


def run_all(out_dir: str, **kw) -> Dict[str, list]:
    """One JSON file a ``valid_cells()`` cell in ``out_dir``
    (``{arch}__{shape}.json``, the reference's names), a skipped cell's
    too; a file that exists already is kept, not recomputed. In process:
    the model is analytic. ``kw``: ``run_cell``'s. Returns the cells
    written and kept."""
    os.makedirs(out_dir, exist_ok=True)
    done = {"written": [], "kept": []}
    for cell in valid_cells():
        tag = f"{cell['arch']}__{cell['shape']}"
        path = os.path.join(out_dir, tag + ".json")
        if os.path.exists(path):
            done["kept"].append(tag)
            continue
        with open(path, "w") as f:
            json.dump(run_cell(cell["arch"], cell["shape"], **kw), f,
                      indent=1)
        done["written"].append(tag)
    return done


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="a single-pod (data, model) shape of 256 ranks, "
                         "e.g. 64,4")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (decode cells)")
    ap.add_argument("--split-model", action="store_true",
                    help="the step split over 'model' (tensor "
                         "parallelism): the port's counterpart of the "
                         "partitioned program the reference plans")
    ap.add_argument("--measured-s", type=float, default=None)
    ap.add_argument("--remat", default="full", choices=list(REMAT_FLAG))
    ap.add_argument("--out", help="a cell's JSON file; with --all, the "
                                  "directory of one file a cell")
    ap.add_argument("--all", action="store_true",
                    help="every valid cell, skipping files that exist")
    args = ap.parse_args(argv)
    if args.mesh_shape and args.multipod:
        ap.error("--mesh-shape is a single-pod shape; drop --multipod")
    mesh = (mesh_of(args.mesh_shape) if args.mesh_shape
            else make_production_mesh(multi_pod=args.multipod))
    kw = dict(mesh=mesh, remat=REMAT_FLAG[args.remat],
              split_model=args.split_model, kv_quant=args.kv_quant)
    if args.all:
        done = run_all(args.out or os.path.join("build", "roofline"), **kw)
        print(json.dumps({k: len(v) for k, v in done.items()}))
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    res = run_cell(args.arch, args.shape, measured_s=args.measured_s, **kw)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
