"""Logical -> mesh sharding rules: the twin of ``repro/models/sharding.py``.

Axis conventions, as in the reference:
  * batch                               -> the data-parallel axes
                                           ("pod", "data") / ("data",)
  * TP (heads / ffn / vocab / experts)  -> "model"
  * FSDP (ZeRO-3 weight shard)          -> "data"

A mesh axis is assigned to a tensor dim only when the dim divides evenly
over it; otherwise the dim is replicated.

The rules run over a ``MeshShape``: axis names and sizes, no processes. A
spec is a tuple with one entry per dimension of its tensor: ``None``
(replicated), an axis name, or a tuple of axis names (the dim split over
their product, the first name major), the reference's ``PartitionSpec``
entries one for one. ``activation_specs`` gives the same dict as the
reference; in the port only its ``"moe"`` entry changes what is computed
(``models/moe.apply_moe`` routes per data shard). The layout entries
(``act``, ``logits``, ``attn_q``, ``attn_kv``) pin XLA's partitioner in the
reference and have no counterpart here.

Sharded storage. ``shard_tree`` cuts a tree into one rank's blocks by its
coordinates; ``gather_tree`` puts the blocks of a tree back together over a
``launch/mesh.Mesh`` with ``AxisGroup.all_gather``, axis by axis. A train
step over such a mesh (``train/step.make_sharded_train_step``) keeps only
the rank's blocks of the parameters and AdamW moments, which is the
reference's memory plan for stored state. By default every rank gathers
each whole leaf and runs the whole model on its batch shard.

The compute split over "model" (``split_model=True``), for the attention
families, RG-LRU (recurrentgemma), xLSTM (mLSTM, sLSTM) and the VLM and
audio frontends: ``model_view`` says which heads, kv heads, FFN columns,
experts, recurrent channels and heads and head columns (vocabulary rows;
audio: (codebook, vocabulary) columns, codebook-major) a model rank
computes, read off ``param_specs``, and raises ``NotImplementedError``
where the split is not ported (``ValueError`` for a tied head with the
audio frontend, which has no meaning). A tied head takes the rank's
vocabulary rows of the embedding (``models/transformer._tied_logits``).
RG-LRU and sLSTM channels that do not divide over "model" run that mixer
whole on every rank (``whole_mixers``), from leaves ``param_specs`` keeps
whole, as the reference computes them. A rank computes whole heads: query,
mLSTM and sLSTM heads are shared out by ``share`` (the first n % tp ranks take
one more; where n < tp some take none), while their leaves stay cut as
``param_specs`` cuts them, a column block that may end mid-head (the
mixers regroup between the two, ``launch/mesh.take_share`` /
``put_share``). kv heads that do not divide over "model" are admitted:
each rank reads the kv heads its query heads need, two or more where its
heads straddle a GQA group. The
decode cache is cut by its length over ``length_axes`` ("model" there; the
data axes first where the batch does not divide over them), as
``decode_state_specs`` cuts it; ``launch/mesh.make_mesh`` lays a process
group over each such tuple of axes (``group_axes``, named by
``axes_name``). ``data_specs`` drops "model" from every spec:
gathering by it (ZeRO-3 over the data axes) leaves each rank its model
blocks, with which ``models/transformer.forward(..., model=)`` runs
Megatron's tensor parallelism, as XLA partitions the reference under these
specs. ``partial_over_model`` says which leaves' gradient each model rank
holds a part of: ``PARTIAL_OVER_MODEL`` (replicated leaves read in part),
and ``PARTIAL_WHEN_WHOLE`` where the dim the split cuts does not divide
(``wq`` / ``wo`` where n_heads x hd does not, the per-head mLSTM and
sLSTM leaves where their heads do not), never a whole mixer's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import _tree
from ..configs.base import ModelConfig

__all__ = ["MeshShape", "dp_axes", "param_specs", "batch_specs",
           "constraint_spec", "activation_specs", "decode_state_specs",
           "local_shape", "shard", "shard_tree", "gather", "gather_tree",
           "spec_leaves", "dp_shards", "ModelView", "model_view",
           "data_specs", "has_model", "PARTIAL_OVER_MODEL",
           "PARTIAL_WHEN_WHOLE", "partial_over_model", "kv_read", "share",
           "SPLIT_ROADMAP", "length_axes", "group_axes", "axes_name",
           "whole_mixers", "refuse_tied_audio"]

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh laid out row-major over its ranks
    (the last axis varies fastest), as ``launch/mesh.make_mesh`` lays a
    world out."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @classmethod
    def of(cls, *axes: Tuple[str, int]) -> "MeshShape":
        return cls(tuple(a for a, _ in axes), tuple(int(s) for _, s in axes))

    @classmethod
    def from_mesh(cls, mesh) -> "MeshShape":
        """The shape of a ``launch/mesh.Mesh``."""
        return cls(tuple(mesh.axis_names),
                   tuple(mesh.shape[a] for a in mesh.axis_names))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    def coords(self, rank: int) -> Dict[str, int]:
        """The coordinates of global rank ``rank``."""
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
            rank, self.sizes))))


def _P(*entries) -> Spec:
    """A spec from its entries; a one-name tuple becomes the name, as a
    ``PartitionSpec`` normalises it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _shape_of(mesh) -> MeshShape:
    return mesh if isinstance(mesh, MeshShape) else MeshShape.from_mesh(mesh)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in _shape_of(mesh).axis_names if a in ("pod", "data"))


def _axsize(mesh, axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = _shape_of(mesh).shape
    return int(np.prod([shape[a] for a in axes]))


def _maybe(mesh, dim: int, axes: Axes) -> Axes:
    """axes if dim divides evenly over them, else replicate."""
    return axes if dim % _axsize(mesh, axes) == 0 else None


def _leaf_spec(names: Sequence[str], shape, mesh, fsdp: str = "data",
               tp: str = "model") -> Spec:
    name = names[-1]
    in_groups = "groups" in names
    nd = len(shape)
    dims = list(shape)

    def spec(*entries) -> Spec:
        full = ([None] + list(entries)) if in_groups else list(entries)
        assert len(full) == nd, (names, shape, full)
        return _P(*full)

    body = dims[1:] if in_groups else dims

    if name == "embed":
        # the model dim, not vocab: the token gather stays whole
        if nd == 3:  # audio: (K, V, D)
            return _P(None, None, _maybe(mesh, dims[2], (fsdp, tp)))
        return _P(None, _maybe(mesh, dims[1], (fsdp, tp)))
    if name == "lm_head":
        return _P(_maybe(mesh, dims[0], fsdp), _maybe(mesh, dims[1], tp))
    if name in ("final_norm", "norm1", "norm2", "b_gates", "b_if", "lam",
                "bq", "bk", "bv", "conv_w"):
        return spec(*([None] * len(body)))
    if name == "router":  # (D, E)
        return spec(_maybe(mesh, body[0], fsdp), None)
    if name in ("w_q", "w_k", "w_v", "r_gates") and len(body) == 3:
        # block-diagonal per-head projections (h, hd, x): heads over TP
        return spec(_maybe(mesh, body[0], tp), None, None)
    if name in ("w_gate", "w_up") and len(body) == 3:     # experts (E, D, F)
        return spec(_maybe(mesh, body[0], tp), _maybe(mesh, body[1], fsdp),
                    None)
    if name == "w_down" and len(body) == 3:               # experts (E, F, D)
        return spec(_maybe(mesh, body[0], tp), None,
                    _maybe(mesh, body[2], fsdp))
    if name in ("wq", "wk", "wv", "w_up", "w_gate", "w_ffn_up", "w_gates",
                "r_gates", "w_in", "w_gate_in", "w_q", "w_k", "w_v",
                "w_rgate", "w_igate", "w_if"):            # (D_in, F_out)
        return spec(_maybe(mesh, body[0], fsdp), _maybe(mesh, body[1], tp))
    if name in ("wo", "w_down", "w_ffn_down", "w_out"):   # (F_in, D_out)
        return spec(_maybe(mesh, body[0], tp), _maybe(mesh, body[1], fsdp))
    return spec(*([None] * len(body)))


def _map_named(fn, tree):
    """``fn(names, leaf)`` over a tree's leaves, ``names`` its path."""
    names, leaves, structure = _tree.flatten_with_names(tree)
    return _tree.unflatten(structure, [fn(n.split("/"), leaf)
                                       for n, leaf in zip(names, leaves)])


def param_specs(params, cfg: ModelConfig, mesh):
    """A spec tree matching the parameter tree (leaves: anything with a
    ``shape``: tensors, meta tensors)."""
    return _map_named(lambda names, leaf: _leaf_spec(names, leaf.shape, mesh),
                      params)


def batch_specs(cfg: ModelConfig, mesh, global_batch: int) -> Dict[str, Spec]:
    """Specs of the input batch dict (tokens / labels / patch_embeds)."""
    dp = dp_axes(mesh)
    bax = dp if global_batch % _axsize(mesh, dp) == 0 else None
    toks = _P(bax, None, None) if cfg.frontend == "audio_codec" \
        else _P(bax, None)
    out = {"tokens": toks, "labels": toks}
    if cfg.frontend == "vlm_patches":
        out["patch_embeds"] = _P(bax, None, None)
    return out


def constraint_spec(cfg: ModelConfig, mesh, global_batch: int) -> Spec:
    """The residual stream's (b, s, d) spec at block boundaries."""
    dp = dp_axes(mesh)
    bax = dp if global_batch % _axsize(mesh, dp) == 0 else None
    return _P(bax, None, None)


def activation_specs(cfg: ModelConfig, mesh, global_batch: int,
                     seq_len: Optional[int] = None, dp=None) -> Dict[str, Any]:
    """The reference's activation specs: ``act`` (b, s, d), ``logits``,
    ``attn_q`` / ``attn_kv`` (b, h, s, hd) where the head count divides the
    model axis, and ``moe``: the data-shard axes, the expert axis and the
    number of data shards ``n_dp`` that ``apply_moe`` routes over. Only
    ``moe`` changes what the port computes."""
    dp = dp_axes(mesh) if dp is None else dp
    bax = dp if global_batch % _axsize(mesh, dp) == 0 else None
    act = _P(bax, None, None)
    if bax is None and seq_len is not None and \
            seq_len % _axsize(mesh, dp) == 0:
        act = _P(None, dp, None)           # sequence-parallel fallback
    vax = "model" if cfg.vocab_size % _axsize(mesh, "model") == 0 else None
    logits = (_P(bax, None, None, vax) if cfg.frontend == "audio_codec"
              else _P(bax, None, vax))
    tp = _axsize(mesh, "model")
    if cfg.n_heads % tp == 0:
        attn_q = attn_kv = _P(bax, "model", None, None)
    else:
        attn_q = attn_kv = None
    moe = None
    if cfg.moe is not None:
        eax = "model" if cfg.moe.n_experts % tp == 0 else None
        moe = {"dp": bax, "e": eax, "n_dp": _axsize(mesh, dp) if bax else 1}
    return {"act": act, "logits": logits, "attn_q": attn_q,
            "attn_kv": attn_kv, "moe": moe}


def decode_state_specs(state, cfg: ModelConfig, mesh, global_batch: int):
    """Specs of the KV caches and recurrent states. Large batches shard
    over the data axes; batch-1 long-context decode shards the cache
    length instead. The step counter (a host integer) gets ``()``."""
    dp = dp_axes(mesh)
    big_batch = global_batch % _axsize(mesh, dp) == 0

    def leaf(names, x) -> Spec:
        name = names[-1]
        if name == "index":
            return ()
        nd = len(x.shape)
        if name in ("k", "v", "k_scale", "v_scale"):   # (g, b, kv, S, hd|1)
            kv_ax = _maybe(mesh, x.shape[2], "model")
            s_model = (_maybe(mesh, x.shape[3], "model") if kv_ax is None
                       else None)
            if big_batch:
                return _P(None, dp, kv_ax, s_model, None)
            s_axes = tuple(a for a in (list(dp) + ["model"])
                           if kv_ax is None or a != "model")
            return _P(None, None, kv_ax, _maybe(mesh, x.shape[3], s_axes),
                      None)
        if name == "c" and nd == 5:     # mlstm (g, b, h, hdk, hdv)
            return _P(None, dp if big_batch else None,
                    _maybe(mesh, x.shape[2], "model"), None, None)
        if name == "n" and nd == 4:     # mlstm (g, b, h, hd)
            return _P(None, dp if big_batch else None,
                    _maybe(mesh, x.shape[2], "model"), None)
        if nd == 3 and name in ("c", "n", "h"):   # slstm / rglru (g, b, d)
            return _P(None, dp if big_batch else None,
                    _maybe(mesh, x.shape[2], "model"))
        if name == "conv":              # (g, b, 3, d)
            return _P(None, dp if big_batch else None, None,
                    _maybe(mesh, x.shape[3], "model"))
        return (None,) * nd

    return _map_named(leaf, state)


def length_axes(cfg: ModelConfig, mesh, global_batch: int
                ) -> Tuple[str, ...]:
    """The axes ``decode_state_specs`` cuts a kv cache's length over, the
    first major (a ring that does not divide over them stays whole):
    "model" where the kv heads do not divide over it; where the batch does
    not divide over the data axes, those axes first."""
    shape = _shape_of(mesh)
    model = (("model",) if "model" in shape.shape
             and cfg.n_kv_heads % shape.shape["model"] else ())
    dp = dp_axes(shape)
    return model if global_batch % _axsize(shape, dp) == 0 else dp + model


def group_axes(mesh) -> list:
    """The tuples of axes, besides the single axes, over which
    ``launch/mesh.make_mesh`` lays a process group out: the data axes
    together and with "model", every ``length_axes`` a mesh with a "model"
    axis can give (none on a mesh without one)."""
    shape = _shape_of(mesh)
    if "model" not in shape.shape:
        return []
    dp = dp_axes(shape)
    return ([dp] if len(dp) > 1 else []) + ([dp + ("model",)] if dp else [])


def axes_name(axes: Axes) -> str:
    """The name of the group over ``axes``: an axis's own name, or the
    names joined by "+" (the first major), as ``Mesh.groups`` keys it."""
    return "+".join(_entry_axes(axes))


# ---------------------------------------------------------------------------
# sharded storage
# ---------------------------------------------------------------------------
def _entry_axes(entry: Axes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """A rank's block shape of a tensor of ``shape`` under ``spec``."""
    return tuple(int(n) // _axsize(mesh, e) for n, e in
                 zip(shape, spec))


def dp_shards(cfg: ModelConfig, mesh, global_batch: int) -> int:
    """How many batch shards ``batch_specs`` cuts: the data-parallel size,
    or 1 where the batch does not divide over it."""
    lead = batch_specs(cfg, mesh, global_batch)["labels"][0]
    return _axsize(mesh, lead)


def shard(x: torch.Tensor, spec: Spec, mesh,
          coords: Dict[str, int]) -> torch.Tensor:
    """The block of ``x`` at ``coords`` under ``spec``: a fresh contiguous
    tensor (the whole of ``x`` may be freed after)."""
    shape = _shape_of(mesh).shape
    index = []
    for n, entry in zip(x.shape, spec):
        axes = _entry_axes(entry)
        parts, pos = 1, 0
        for a in axes:                       # the first axis is major
            pos = pos * shape[a] + coords[a]
            parts *= shape[a]
        size = n // parts
        index.append(slice(pos * size, (pos + 1) * size))
    return x[tuple(index)].clone(memory_format=torch.contiguous_format)


def spec_leaves(specs) -> list:
    """A spec tree's specs in the leaf order of ``_tree`` (dict keys
    sorted): the tuples are the leaves; ``None`` holds none, as in
    ``_tree``."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [] if specs is None else [specs]


def shard_tree(tree, specs, mesh_shape, coords: Dict[str, int]):
    """Each tensor leaf of ``tree`` cut to its block at ``coords``;
    leaves that are not tensors pass through."""
    _, leaves, structure = _tree.flatten_with_names(tree)
    specs = spec_leaves(specs)
    if len(specs) != len(leaves):
        raise ValueError("the spec tree does not match the tree")
    return _tree.unflatten(structure, [
        shard(x, s, mesh_shape, coords) if isinstance(x, torch.Tensor) else x
        for x, s in zip(leaves, specs)])


def gather(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from this rank's block ``x`` over a
    ``launch/mesh.Mesh``: for each sharded dim, ``all_gather`` over its
    axes, the last (minor) first."""
    for dim, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            g = mesh.axis(a).all_gather(x)              # (n, *x.shape)
            x = g.movedim(0, dim).flatten(dim, dim + 1)
    return x


def gather_tree(tree, specs, mesh):
    """The whole tree from this rank's blocks (``shard_tree``'s inverse)."""
    _, leaves, structure = _tree.flatten_with_names(tree)
    specs = spec_leaves(specs)
    if len(specs) != len(leaves):
        raise ValueError("the spec tree does not match the tree")
    return _tree.unflatten(structure, [
        gather(x, s, mesh) if isinstance(x, torch.Tensor) else x
        for x, s in zip(leaves, specs)])


# ---------------------------------------------------------------------------
# the compute split over "model"
# ---------------------------------------------------------------------------
# replicated leaves used per head (the qkv biases, sliced to a rank's heads),
# per channel or head (RG-LRU's conv kernel and decay, the xLSTM gate
# biases) or feeding only a rank's experts (the router): each model rank's
# gradient is a part of the whole, summed over "model" before the update
PARTIAL_OVER_MODEL = ("bq", "bk", "bv", "router", "conv_w", "lam", "b_if",
                      "b_gates")
# leaves the split cuts over "model" but whose dim may not divide (then
# ``param_specs`` keeps them whole): each rank reads its part of a whole one
# (its heads' columns or rows of wq / wo, its heads of the per-head mLSTM
# and sLSTM projections, its channel block's rows of mLSTM's w_if)
PARTIAL_WHEN_WHOLE = ("wq", "wk", "wv", "wo", "w_q", "w_k", "w_v",
                      "w_if", "r_gates", "w_ffn_up", "w_ffn_down")
SPLIT_ROADMAP = ('ROADMAP.md, "Configurations the port does not yet run": '
                 'the compute split over "model"')
_SPLIT_KINDS = ("attn", "swa", "rglru", "mlstm", "slstm")


def whole_mixers(cfg: ModelConfig, tp: int) -> Tuple[str, ...]:
    """The block kinds whose mixer every model rank of ``tp`` computes
    whole: RG-LRU and sLSTM where ``d_model`` does not divide over "model"
    (``param_specs`` then keeps their channel leaves whole, as the
    reference's ``_maybe`` does, and ``decode_state_specs`` their state)."""
    if tp <= 1 or cfg.d_model % tp == 0:
        return ()
    return tuple(k for k in ("rglru", "slstm")
                 if k in cfg.pattern_for_layers())


def partial_over_model(name: str, spec: Spec,
                       whole: Tuple[str, ...] = ()) -> bool:
    """Whether the gradient of the leaf at path ``name`` (its last part
    counts) stored under ``spec`` is each model rank's part of the whole.
    ``whole``: the kinds whose mixer runs whole on every rank
    (``whole_mixers``): their mixer leaves' gradients are whole (equal on
    every rank, or the rank's block of a whole one), never parts."""
    parts = [p for p in name.split("/") if p]
    if any(p.startswith("blk") and p.split("_", 1)[1] in whole
           for p in parts) and "mixer" in parts:
        return False
    leaf = parts[-1]
    return leaf in PARTIAL_OVER_MODEL or (leaf in PARTIAL_WHEN_WHOLE
                                          and not has_model(spec))


def refuse_tied_audio(cfg: ModelConfig) -> None:
    """A tied head with the audio frontend has no meaning: the reference's
    logits are ``None`` there (its (K, V, D) embedding has no one
    transpose to multiply by) and its reshape fails. Raise ``ValueError``
    naming the cause, where the reference fails."""
    if cfg.tie_embeddings and cfg.frontend == "audio_codec":
        raise ValueError(
            f"{cfg.name}: tie_embeddings with the audio_codec frontend: a "
            f"(K, V, D) embedding of {cfg.n_codebooks} codebooks has no "
            f"transpose to serve as the head (the reference's logits are "
            f"None there); untie it")


@dataclasses.dataclass(frozen=True)
class ModelView:
    """What model rank ``index`` of ``tp`` computes: [start, stop) of the
    query heads (its ``share``: possibly none), the kv heads they read
    (``kv_cut``: the kv heads divide over "model" and are this rank's own;
    else the rank reads them whole, ``kv_read`` of its heads, and the
    decode cache is cut by length), FFN columns (the dense and
    shared-expert FFN), experts, RG-LRU channels, mLSTM and sLSTM heads
    (shares) and the head's columns (``vocab``: vocabulary rows, or
    audio's K V (codebook, vocabulary) columns, codebook-major; ``None``
    where the model has none).
    ``q_cols`` / ``mlstm_cols`` / ``slstm_cols``: the stored block of
    ``wq``'s columns, of ``w_up``'s and of ``w_gates``' 4 d (gate-major),
    which may cut a head mid-way (``None`` where the leaf is whole on
    every rank, or the model has none): where it is not the rank's heads'
    columns the mixer regroups between the two.
    ``embed_pieces``: the embedding's model dim is cut over (data axes...,
    "model"), so after the data-axis gather a rank holds ``embed_pieces``
    strided pieces of it (``embed_cut``; else the table is whole on every
    rank, where the dim does not divide). ``whole``: the kinds whose mixer
    every rank computes whole (``whole_mixers``); ``channels`` and
    ``slstm_heads`` are then every channel and head."""

    tp: int
    index: int
    heads: Optional[Tuple[int, int]]
    kv_heads: Optional[Tuple[int, int]]
    kv_cut: bool
    ffn_cols: Optional[Tuple[int, int]]
    experts: Optional[Tuple[int, int]]
    channels: Optional[Tuple[int, int]]
    mlstm_heads: Optional[Tuple[int, int]]
    slstm_heads: Optional[Tuple[int, int]]
    vocab: Tuple[int, int]
    embed_pieces: int
    q_cols: Optional[Tuple[int, int]] = None
    mlstm_cols: Optional[Tuple[int, int]] = None
    slstm_cols: Optional[Tuple[int, int]] = None
    embed_cut: bool = True
    whole: Tuple[str, ...] = ()


def has_model(spec: Spec) -> bool:
    """Whether ``spec`` cuts a dim over "model"."""
    return any("model" in _entry_axes(e) for e in spec)


def data_specs(specs, mesh):
    """``specs`` with "model" and every one-rank axis taken out of each
    entry: gathering by them brings a rank's blocks whole over the data
    axes and leaves the model cut in place."""
    sizes = _shape_of(mesh).shape

    def strip(spec):
        return _P(*[tuple(a for a in _entry_axes(e)
                          if a != "model" and sizes[a] > 1) or None
                    for e in spec])

    if isinstance(specs, dict):
        return {k: data_specs(v, mesh) for k, v in specs.items()}
    return None if specs is None else strip(specs)


def _block(n: int, tp: int, index: int) -> Tuple[int, int]:
    per = n // tp
    return (index * per, (index + 1) * per)


def share(n: int, tp: int, index: int) -> Tuple[int, int]:
    """[start, stop) of the ``n`` heads model rank ``index`` of ``tp``
    computes: as even as whole heads allow, the first n % tp ranks one
    more (``_block`` where tp divides n; where n < tp the last ranks
    none)."""
    per, extra = divmod(n, tp)
    start = index * per + min(index, extra)
    return (start, start + per + int(index < extra))


def kv_read(n_heads: int, n_kv_heads: int,
            heads: Tuple[int, int]) -> Tuple[int, int]:
    """[start, stop) of the kv heads the query heads ``heads`` read (GQA:
    query head h reads kv head h // (n_heads / n_kv_heads)); none for no
    heads."""
    rep = n_heads // n_kv_heads
    if heads[1] <= heads[0]:
        return (heads[0] // rep,) * 2
    return (heads[0] // rep, (heads[1] - 1) // rep + 1)


# the leaves of each block kind that a split rank must hold a model block
# of (attention's wq / wo and the per-head mLSTM and sLSTM leaves may be
# whole: the rank reads its heads of them)
_CUT_LEAVES = {
    "attn": (), "swa": (),
    "rglru": ("w_in", "w_gate_in", "w_rgate", "w_igate", "w_out"),
    "mlstm": ("w_up", "w_gate", "w_down"),
    "slstm": ("w_gates",),
}


def _cols(spec: Spec, n: int, tp: int, index: int):
    """The stored block [start, stop) of a leaf's last dim of ``n`` under
    ``spec`` on model rank ``index`` (``None`` where it is whole)."""
    return _block(n, tp, index) if has_model(spec[-1:]) else None


def model_view(cfg: ModelConfig, mesh, index: int = 0) -> ModelView:
    """Model rank ``index``'s share of ``cfg`` under ``param_specs`` on
    ``mesh``. Raises ``NotImplementedError`` (naming the ROADMAP item)
    where the split is not ported: mixers other than ``_SPLIT_KINDS``', or
    a leaf the split needs cut over "model" (the head's columns, an FFN's,
    a split mixer's channels) that does not divide over it; ``ValueError``
    for a tied head with the audio frontend (``refuse_tied_audio``). Query,
    mLSTM and sLSTM heads that do not divide are shared out (``share``);
    RG-LRU and sLSTM channels that do not divide run whole on every rank
    (``whole_mixers``); a tied head takes its vocabulary rows of the
    embedding (``models/transformer._head``). Nothing falls back to
    another route."""
    # transformer imports launch/mesh, which imports this module
    from .recurrent import _slstm_hd, mlstm_heads
    from .transformer import block_has_ffn, init_params
    shape = _shape_of(mesh)
    tp = shape.shape.get("model", 1)
    pattern = cfg.pattern_for_layers()
    kinds = set(pattern)
    attn = bool(kinds & {"attn", "swa"})
    d = cfg.d_model
    n_mlstm = mlstm_heads(cfg) if "mlstm" in kinds else None
    n_slstm = d // _slstm_hd(d) if "slstm" in kinds else None
    refuse_tied_audio(cfg)
    whole = whole_mixers(cfg, tp)
    why = None
    if not kinds <= set(_SPLIT_KINDS):
        why = f"mixers {sorted(kinds - set(_SPLIT_KINDS))}"
    kv_cut = attn and cfg.n_kv_heads % tp == 0
    if why is None:
        specs = param_specs(init_params(None, cfg, device="meta"), cfg,
                            shape)
        need = ([] if cfg.tie_embeddings else
                [("lm_head", specs["lm_head"])])
        if cfg.tie_embeddings and cfg.vocab_size % tp:
            need.append(("embed (a tied head's vocabulary)", (None,)))
        for i, kind in enumerate(pattern):
            blk = specs["groups"][f"blk{i}_{kind}"]
            leaves = ((() if kind in whole else _CUT_LEAVES[kind])
                      + (("wk", "wv") if kv_cut and kind in ("attn", "swa")
                         else ()))
            need += [(f"{kind}/{k}", blk["mixer"][k]) for k in leaves]
            if block_has_ffn(cfg, kind):
                need += [("ffn/" + k, blk["ffn"][k])
                         for k in ("w_gate", "w_up", "w_down")]
                if "shared" in blk["ffn"]:
                    need += [("shared/" + k, blk["ffn"]["shared"][k])
                             for k in ("w_gate", "w_up", "w_down")]
        cut = sorted({name for name, spec in need if not has_model(spec)})
        if tp > 1 and cut:
            why = f"leaves not cut over 'model': {cut}"
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: the compute split over 'model' is not ported for "
            f"{why}; see {SPLIT_ROADMAP}")
    emb = specs["embed"][-1]
    embed_cut = has_model((emb,))
    pieces = _axsize(shape, tuple(a for a in _entry_axes(emb)
                                  if a != "model")) if embed_cut else 1
    m = cfg.moe
    heads = share(cfg.n_heads, tp, index) if attn else None
    dense_ffn = any(block_has_ffn(cfg, k) for k in kinds) and m is None
    mixers = {kind: specs["groups"][f"blk{i}_{kind}"]["mixer"]
              for i, kind in enumerate(pattern)}
    mixer = mixers.get("attn", mixers.get("swa"))
    return ModelView(
        tp=tp, index=index, heads=heads,
        kv_heads=(None if not attn else _block(cfg.n_kv_heads, tp, index)
                  if kv_cut else kv_read(cfg.n_heads, cfg.n_kv_heads, heads)),
        kv_cut=kv_cut,
        ffn_cols=(_block(m.d_expert * m.n_shared_experts, tp, index)
                  if m is not None and m.n_shared_experts else
                  _block(cfg.d_ff, tp, index) if dense_ffn else None),
        experts=_block(m.n_experts, tp, index) if m is not None else None,
        channels=(None if "rglru" not in kinds else (0, d)
                  if "rglru" in whole else _block(d, tp, index)),
        mlstm_heads=(share(n_mlstm, tp, index) if n_mlstm is not None
                     else None),
        slstm_heads=(None if n_slstm is None else (0, n_slstm)
                     if "slstm" in whole else share(n_slstm, tp, index)),
        vocab=_block(cfg.vocab_size * (cfg.n_codebooks if cfg.frontend
                                       == "audio_codec" else 1), tp, index),
        embed_pieces=pieces,
        q_cols=(_cols(mixer["wq"], cfg.n_heads * cfg.hd, tp, index)
                if attn else None),
        mlstm_cols=(_cols(mixers["mlstm"]["w_up"], 2 * d, tp, index)
                    if n_mlstm is not None else None),
        slstm_cols=(_cols(mixers["slstm"]["w_gates"], 4 * d, tp, index)
                    if n_slstm is not None else None),
        embed_cut=embed_cut, whole=whole)
