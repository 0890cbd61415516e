"""Process groups: the torch meaning of ``repro/launch/mesh.py``.

The reference lays JAX devices out as a named mesh and runs collectives
over its axes inside ``shard_map``. Here every position of the mesh is one
process, a rank of ``torch.distributed``, and a ``Mesh`` is one rank's view
of the world laid out row-major over named axes: its coordinates and, for
each axis, an ``AxisGroup``: the process group of the ranks that differ
from it only along that axis, with the collectives the port runs over it.

``make_test_mesh`` lays the world out as ``("pod", "data")`` (two pods,
``multi_pod=True``) or as ``("nodes",)``. ``spawn_ranks`` starts N rank
processes, each joining one process group through a fresh temporary file
(no TCP port, so concurrent test workers never collide), runs a function in
each and returns what each returned; a rank that raises fails the call.

Transport. The backend is the caller's argument and nothing switches by
itself. NCCL moves CUDA tensors, one card a rank. Gloo moves host tensors:
ranks that share a card use it with their compute on the card, and every
collective over a CUDA tensor then copies the payload into a pinned host
buffer, runs there and copies the result back; the arithmetic around the
collectives stays on the card. ``AxisGroup`` counts those bytes, both
ways, in ``host_staged_bytes``.

Wire bytes. Each ``AxisGroup`` also counts, by kind, the bytes its
collectives put on the wire as a ring implementation sends them, with the
factors of the reference's HLO collective parser
(``repro/launch/hlo_analysis.py``): an all-reduce 2 (n - 1) / n of its
payload, an all-gather (n - 1) / n of its result, a reduce-scatter
and an all-to-all (n - 1) / n of its input, a point-to-point exchange
its payload once a peer (the reference's collective-permute).
Kept per axis, the "pod" axis's share is what crosses pods: the port's
counterpart of the reference's ``cross_pod_bytes``. A group over a tuple
of axes (``Mesh.group``) keeps its own count.

Tensor parallelism. ``copy_to_model``, ``reduce_from_model``,
``gather_from_model`` and ``gather_summed_from_model`` are the autograd-aware
collectives of a compute split over the "model" axis (Megatron's f / g pair and
its two gathers), built on ``AxisGroup``'s collectives so their bytes are
counted: copy is the identity forward and an all-reduce of the gradient
backward, reduce an all-reduce forward (in f32, of ``partial_product``'s f32
parts) and the identity backward. Both gathers concatenate every rank's block
forward. Backward, ``gather_from_model`` takes this rank's slice of the
gradient, right where every rank's consumer of the whole is the same (the
residual stream); ``gather_summed_from_model`` reduce-scatters it (sums it over
the ranks, then takes the slice), right where each rank consumes the whole
differently (a kv head read by each rank's query heads, a recurrent state
feeding each rank's gate columns). ``scatter_summed_to_model`` runs the other
way: a reduce-scatter forward of a whole-width tensor in which each rank
filled its own part, an all-gather of the gradient backward.
``slice_to_model`` takes this rank's block of a whole tensor, its gradient
all-gathered; ``rows_from_model`` turns a block of columns of every row into
whole rows of the rank's row block by one all-to-all (a tied head's
embedding), its gradient by another. On them,
``take_share`` and ``put_share`` move a tensor between a stored block (n /
tp, which may end mid-head) and the rank's whole heads (``share_of``:
``models/sharding.share``). Given ``None`` (one rank) or a one-rank axis,
each returns its input.

``make_production_mesh`` gives the reference's production mesh shapes,
(16, 16) and (2, 16, 16), as a ``models/sharding.MeshShape``: names and
sizes with no processes, which the sharding rules and the dry run
(``launch/dryrun.py``) run over. The reference's ``HW`` (TPU v5e
constants) becomes ``launch/roofline.HW``, the H100's.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..models.sharding import MeshShape, axes_name, group_axes, share

__all__ = ["AxisGroup", "Mesh", "make_mesh", "make_test_mesh",
           "make_production_mesh", "rank_device", "spawn_ranks",
           "WIRE_FACTOR", "copy_to_model", "reduce_from_model",
           "gather_from_model", "gather_summed_from_model",
           "scatter_summed_to_model", "share_of", "take_share", "put_share",
           "partial_product", "split_axis", "rows_from_model",
           "slice_to_model"]

# wire bytes of a ring collective over n ranks per byte of its payload
# (all-reduce), its result (all-gather) or its message (collective-permute):
# the factors of repro/launch/hlo_analysis.py
WIRE_FACTOR = {
    "all-reduce": lambda n: 2.0 * (n - 1) / max(n, 1),
    "all-gather": lambda n: (n - 1) / max(n, 1),
    "reduce-scatter": lambda n: (n - 1) / max(n, 1),
    "all-to-all": lambda n: (n - 1) / max(n, 1),
    "collective-permute": lambda n: 1.0,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class AxisGroup:
    """The ranks along one mesh axis, seen from one of them.

    ``ranks`` are the global ranks in axis order, ``index`` is this rank's
    place among them, ``group`` their ``torch.distributed`` process group.
    Under gloo a CUDA payload goes through a pinned host buffer (one cached
    per use and dtype, grown to the largest payload), counted in
    ``host_staged_bytes``.
    ``wire_bytes`` counts by kind the bytes its collectives send
    (``WIRE_FACTOR``), ``calls`` how many of each it ran.
    """

    def __init__(self, name: str, ranks: Sequence[int], index: int, group,
                 backend: str):
        self.name = name
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = index
        self.group = group
        self.backend = backend
        self.host_staged_bytes = 0
        self.wire_bytes = {"all-reduce": 0.0, "all-gather": 0.0,
                           "reduce-scatter": 0.0, "all-to-all": 0.0,
                           "collective-permute": 0.0}
        self.calls = dict.fromkeys(self.wire_bytes, 0)
        self._pinned: Dict[tuple, torch.Tensor] = {}

    def _wire(self, kind: str, nbytes: int) -> None:
        self.wire_bytes[kind] += WIRE_FACTOR[kind](self.size) * nbytes
        self.calls[kind] += 1

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _buffer(self, use: str, shape, dtype) -> torch.Tensor:
        """A pinned buffer of ``shape``: a view of one flat buffer a (use,
        dtype), grown to the largest payload yet (a collective copies in,
        runs and copies out before it returns, so one buffer a use
        serves every call)."""
        key = (use, dtype)
        n = math.prod(shape)
        if key not in self._pinned or self._pinned[key].numel() < n:
            self._pinned.pop(key, None)
            self._pinned[key] = torch.empty(n, dtype=dtype, pin_memory=True)
        return self._pinned[key][:n].view(tuple(shape))

    def _to_host(self, t: torch.Tensor, use: str) -> torch.Tensor:
        buf = self._buffer(use, t.shape, t.dtype)
        buf.copy_(t)                    # pinned destination, synchronous
        self.host_staged_bytes += _nbytes(t)
        return buf

    def _from_host(self, buf: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        out.copy_(buf)                  # synchronous: the buffer is reused
        self.host_staged_bytes += _nbytes(buf)
        return out

    def all_reduce_(self, t: torch.Tensor,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` (contiguous) over the axis in place; returns it."""
        self._wire("all-reduce", _nbytes(t))
        if not self._staged(t):
            dist.all_reduce(t, op=op, group=self.group)
            return t
        buf = self._to_host(t, "reduce")
        dist.all_reduce(buf, op=op, group=self.group)
        return self._from_host(buf, t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t`` in axis order."""
        shape = (self.size,) + tuple(t.shape)
        self._wire("all-gather", self.size * _nbytes(t))
        if not self._staged(t):
            out = torch.empty(shape, dtype=t.dtype, device=t.device)
            dist.all_gather(list(out.unbind(0)), t.contiguous(),
                            group=self.group)
            return out
        src = self._to_host(t, "gather_in")
        buf = self._buffer("gather_out", shape, t.dtype)
        dist.all_gather(list(buf.unbind(0)), src, group=self.group)
        return self._from_host(buf, torch.empty(shape, dtype=t.dtype,
                                                device=t.device))

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's slice along ``dim`` (``size`` equal slices in axis
        order) of the sum of every rank's ``t``."""
        self._wire("reduce-scatter", _nbytes(t))
        dim %= t.dim()
        parts = t.movedim(dim, 0).unflatten(0, (self.size, -1)).contiguous()
        shape = tuple(parts.shape[1:])
        if not self._staged(t):
            out = torch.empty(shape, dtype=t.dtype, device=t.device)
            dist.reduce_scatter(out, list(parts.unbind(0)), group=self.group)
        else:
            src = self._to_host(parts, "scatter_in")
            buf = self._buffer("scatter_out", shape, t.dtype)
            dist.reduce_scatter(buf, list(src.unbind(0)), group=self.group)
            out = self._from_host(buf, torch.empty(shape, dtype=t.dtype,
                                                   device=t.device))
        return out.movedim(0, dim)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (size, ...): its slice i goes to the rank of axis index i;
        returns (size, ...), slice j from the rank of axis index j."""
        self._wire("all-to-all", _nbytes(t))
        t = t.contiguous()
        if not self._staged(t):
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t, group=self.group)
            return out
        src = self._to_host(t, "a2a_in")
        buf = self._buffer("a2a_out", t.shape, t.dtype)
        dist.all_to_all_single(buf, src, group=self.group)
        return self._from_host(buf, torch.empty_like(t))

    def exchange(self, t: torch.Tensor, peers: Sequence[int]
                 ) -> torch.Tensor:
        """Send ``t`` to every peer (axis indices) and receive one block
        from each, all in one ``batch_isend_irecv``: (len(peers),
        *t.shape), in the order of ``peers``. A ring's neighbours, a
        graph's neighbours, or the reference's ``ppermute`` (peers i - s)."""
        shape = (len(peers),) + tuple(t.shape)
        if not peers:                   # a node with no neighbours
            return torch.empty(shape, dtype=t.dtype, device=t.device)
        self._wire("collective-permute", len(peers) * _nbytes(t))
        staged = self._staged(t)
        src = self._to_host(t, "send") if staged else t.contiguous()
        recv = (self._buffer("recv", shape, t.dtype) if staged
                else torch.empty(shape, dtype=t.dtype, device=t.device))
        ops = [dist.P2POp(dist.isend, src, self.ranks[p], self.group)
               for p in peers]
        ops += [dist.P2POp(dist.irecv, recv[k], self.ranks[p], self.group)
                for k, p in enumerate(peers)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if not staged:
            return recv
        return self._from_host(recv, torch.empty(shape, dtype=t.dtype,
                                                 device=t.device))


def split_axis(group) -> bool:
    """Whether ``group`` (an ``AxisGroup`` or ``None``) spans more than one
    rank, so that a compute split over it runs collectives."""
    return group is not None and group.size > 1


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce_(
            grad.clone(memory_format=torch.contiguous_format)), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return group.all_reduce_(x.to(torch.float32,
                                      memory_format=torch.contiguous_format,
                                      copy=True))

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


class _PartialProduct(torch.autograd.Function):
    """a @ w as f32: on the card cuBLAS's f32 accumulator is returned,
    not rounded to a's dtype. The gradients are a's dtype's, as of a @ w."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        a2 = a.reshape(-1, a.shape[-1])
        out = (torch.mm(a2, w, out_dtype=torch.float32) if a.is_cuda
               else a2.float() @ w.float())
        return out.reshape(*a.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        a, w = ctx.saved_tensors
        g = grad.to(a.dtype)
        gw = a.reshape(-1, a.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
        return g @ w.mT, gw


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return torch.cat(group.all_gather(x).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        part = grad.narrow(ctx.dim, ctx.group.index * ctx.size, ctx.size)
        return part.contiguous(), None, None


class _GatherSummedFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(group.all_gather(x).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.reduce_scatter(grad, ctx.dim), None, None


class _ScatterSummedToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(ctx.group.all_gather(grad.contiguous()).unbind(0),
                         dim=ctx.dim), None, None


class _RowsFromModel(torch.autograd.Function):
    """(V, pieces, c) column pieces of every row -> (V / tp, D) whole rows
    of this rank's row block, by an all-to-all; backward the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.shape = group, x.shape
        rows = x.shape[0] // group.size
        got = group.all_to_all(x.unflatten(0, (group.size, rows)))
        return got.permute(1, 2, 0, 3).reshape(rows, -1)

    @staticmethod
    def backward(ctx, grad):
        v, pieces, c = ctx.shape
        parts = grad.reshape(v // ctx.group.size, pieces, ctx.group.size, c)
        return ctx.group.all_to_all(parts.permute(2, 0, 1, 3)).reshape(
            v, pieces, c), None


class _SliceToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // group.size
        return x.narrow(dim, group.index * n, n)

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(ctx.group.all_gather(grad.contiguous()).unbind(0),
                         dim=ctx.dim), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` into a column-parallel span: the identity, and the gradient
    summed over ``group`` on the way back (each rank's span sees only its
    share of the columns)."""
    return _CopyToModel.apply(x, group) if split_axis(group) else x


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's partial ``x`` (a row-parallel
    product's output), in f32 (the caller rounds it once to its dtype);
    the gradient passes through unchanged, in ``x``'s dtype."""
    return _ReduceFromModel.apply(x, group) if split_axis(group) else x


def partial_product(a: torch.Tensor, w: torch.Tensor,
                    group) -> torch.Tensor:
    """``a @ w`` where it is this rank's part of a sum over ``group`` (a
    row-parallel weight block): under a split of a model in bf16, the f32
    product, so that ``reduce_from_model`` sums the parts unrounded and
    the whole is rounded once, as one process rounds its whole product
    (each part rounded to bf16 first put recurrentgemma-2b's logits 0.030
    relative RMS from one process's). Otherwise ``a @ w``."""
    if not split_axis(group) or a.dtype == torch.float32:
        return a @ w
    return _PartialProduct.apply(a, w)


def gather_from_model(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's block ``x`` concatenated along ``dim`` in axis order;
    the gradient comes back as this rank's slice (the consumer runs the
    same on every rank, so the slices make up the whole)."""
    if not split_axis(group):
        return x
    return _GatherFromModel.apply(x, group, dim % x.dim())


def gather_summed_from_model(x: torch.Tensor, group,
                             dim: int = -1) -> torch.Tensor:
    """Every rank's block ``x`` concatenated along ``dim`` in axis order;
    the gradient comes back summed over ``group`` and sliced to this rank's
    block (a reduce-scatter), as it must where each rank's consumer of the
    whole differs."""
    if not split_axis(group):
        return x
    return _GatherSummedFromModel.apply(x, group, dim % x.dim())


def scatter_summed_to_model(x: torch.Tensor, group,
                            dim: int = -1) -> torch.Tensor:
    """This rank's block along ``dim`` (``size`` equal blocks in axis
    order) of the sum over ``group`` of every rank's whole-width ``x`` (a
    reduce-scatter): ``gather_summed_from_model``'s opposite. The gradient
    comes back gathered whole (an all-gather): every rank's ``x`` feeds
    every rank's block."""
    if not split_axis(group):
        return x
    return _ScatterSummedToModel.apply(x, group, dim % x.dim())


def rows_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of ``x``'s rows (V / size of them), whole: ``x``
    holds a (V, pieces, c) column block of every row, whose pieces
    interleave over ``group`` (column (p size + rank) c + k), as a tied
    head's embedding is cut. One all-to-all sends each rank the rows it
    takes; the gradient goes back the same way, each element to the rank
    that holds it (no sum: one rank's rows meet each element)."""
    if not split_axis(group):
        return x.flatten(-2)
    return _RowsFromModel.apply(x, group)


def slice_to_model(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` (``size`` equal blocks in axis
    order) of a whole ``x`` held the same on every rank; the gradient comes
    back whole, every rank's block gathered (``gather_from_model``'s
    opposite: each block's consumer is on one rank)."""
    if not split_axis(group):
        return x
    return _SliceToModel.apply(x, group, dim % x.dim())


def share_of(n: int, group) -> Tuple[int, int]:
    """[start, stop) of ``n`` heads this rank of ``group`` computes
    (``models/sharding.share``); all of them unsplit."""
    return share(n, group.size, group.index) if split_axis(group) else (0, n)


def take_share(t: torch.Tensor, part: Tuple[int, int], n: int, group,
               dim: int = -1) -> torch.Tensor:
    """[start, stop) ``part`` along ``dim`` of a tensor of ``n`` there, of
    which ``t`` holds the whole or this rank's stored block (n / size in
    axis order): the block itself where it is ``part``, else the block
    gathered whole (``gather_summed_from_model``: each rank reads its own
    part of it) and narrowed."""
    lo, hi = part
    if (lo, hi) == (0, t.shape[dim]):
        return t
    if t.shape[dim] != n:
        if part == share(n, group.size, group.index):
            return t
        t = gather_summed_from_model(t, group, dim)
    return t.narrow(dim, lo, hi - lo)


def put_share(t: torch.Tensor, part: Tuple[int, int], n: int, group,
              dim: int = -1, whole: bool = False) -> torch.Tensor:
    """``t``, [start, stop) ``part`` along ``dim`` of a tensor of ``n``
    there, as that tensor's whole (``whole``) or this rank's stored block,
    summed over ``group`` from every rank's part (zeros elsewhere): the
    block by ``scatter_summed_to_model``, the whole by an f32 all-reduce
    whose gradient is all-reduced too (``reduce_from_model`` inside
    ``copy_to_model``). ``t`` itself where it is already that block, or
    unsplit."""
    if not split_axis(group) or (not whole and n % group.size == 0
                                 and part == share(n, group.size,
                                                   group.index)):
        return t
    dim %= t.dim()
    full = F.pad(t, [0, 0] * (t.dim() - 1 - dim) + [part[0], n - part[1]])
    if whole:
        return copy_to_model(reduce_from_model(full, group).to(t.dtype),
                             group)
    return scatter_summed_to_model(full, group, dim)


@dataclasses.dataclass
class Mesh:
    """This rank's place in a world laid out row-major over named axes."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, AxisGroup]
    device: torch.device
    backend: str

    def axis(self, name: str) -> AxisGroup:
        return self.groups[name]

    def group(self, axes) -> AxisGroup:
        """The group over an axis or a tuple of axes (the first major),
        as ``make_mesh`` laid it out (``sharding.group_axes``)."""
        name = axes_name(axes)
        if name not in self.groups:
            raise KeyError(f"no process group over {name}: the mesh lays "
                           f"out {sorted(self.groups)}")
        return self.groups[name]

    @property
    def host_staged_bytes(self) -> int:
        return sum(g.host_staged_bytes for g in self.groups.values())

    def wire_bytes(self) -> Dict[str, Dict[str, float]]:
        """axis -> kind -> the bytes this rank's collectives sent."""
        return {a: dict(g.wire_bytes) for a, g in self.groups.items()}


def make_mesh(axes: Sequence[Tuple[str, int]], *,
              device: DeviceLike = None,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """Lay the initialised world, or its global ranks ``ranks``, out over
    ``axes`` ((name, size), ...), row-major: the last axis varies fastest
    along the ranks.

    Every rank of the world creates every axis group, then a group over
    each tuple of ``sharding.group_axes`` (its ranks row-major over the
    tuple, the first axis major, keyed by ``sharding.axes_name``: the
    groups a decode cache's length is cut over), in the same order
    (``new_group`` is collective over the whole world, so none may be made
    later by some ranks only), and keeps the ones it belongs to; a rank
    outside ``ranks`` gets ``None``.
    """
    names = tuple(a for a, _ in axes)
    sizes = tuple(int(s) for _, s in axes)
    world, me = dist.get_world_size(), dist.get_rank()
    members = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if int(np.prod(sizes)) != len(members):
        raise ValueError(f"mesh {dict(axes)} needs {int(np.prod(sizes))} "
                         f"ranks, it is given {len(members)}")
    grid = np.asarray(members).reshape(sizes)
    backend = dist.get_backend()
    groups = {}
    for tup in [(n,) for n in names] + group_axes(MeshShape(names, sizes)):
        ks = [names.index(a) for a in tup]
        moved = np.moveaxis(grid, ks, list(range(-len(ks), 0)))
        name = axes_name(tup)
        for line in moved.reshape(-1, math.prod(sizes[k] for k in ks)):
            line = [int(r) for r in line]
            group = dist.new_group(line)
            if me in line:
                groups[name] = AxisGroup(name, line, line.index(me),
                                         group, backend)
    if me not in members:
        return None
    coords = dict(zip(names, (int(c) for c in np.unravel_index(
        members.index(me), sizes))))
    return Mesh(names, dict(zip(names, sizes)), coords, groups,
                resolve_device(device), backend)


def make_test_mesh(*, multi_pod: bool = False,
                   device: DeviceLike = None) -> Mesh:
    """The whole world as ``("pod", "data")`` with 2 pods (``multi_pod``)
    or as ``("nodes",)``."""
    world = dist.get_world_size()
    if multi_pod:
        if world % 2:
            raise ValueError(f"two pods need an even world, got {world}")
        return make_mesh((("pod", 2), ("data", world // 2)), device=device)
    return make_mesh((("nodes", world),), device=device)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"): the reference's production meshes, as shapes."""
    if multi_pod:
        return MeshShape.of(("pod", 2), ("data", 16), ("model", 16))
    return MeshShape.of(("data", 16), ("model", 16))


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """A rank's device: ``device`` as given, or for a bare ``"cuda"`` the
    card ``rank % device_count`` (one card: every rank shares it)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               device: DeviceLike, init_file: str, out_dir: str,
               args: tuple, timeout_s: float) -> None:
    torch.set_num_threads(1)     # N ranks share the host's cores
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world_size, dev, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable[..., Any], world_size: int, *,
                backend: str = "gloo", device: DeviceLike = None,
                args: tuple = (), timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` new
    processes, one process group over them, and return each rank's result.

    ``fn`` must be importable by name (a module-level function: the ranks
    start by ``spawn``); its result travels back through ``torch.save``,
    tensors onto the CPU. Each rank calls ``torch.set_num_threads(1)``.
    ``device`` defaults to CUDA (``rank_device``). A rank that raises or
    dies fails the call: the others are stopped, and this raises with the
    rank's traceback. ``timeout_s`` bounds every collective.
    """
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main,
            args=(fn, world_size, backend, device, os.path.join(tmp, "init"),
                  tmp, tuple(args), timeout_s),
            nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]

