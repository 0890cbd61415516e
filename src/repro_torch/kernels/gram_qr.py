"""CUDA wrapper for the Hopper Gram kernel of CholeskyQR (``csrc/gram_qr.cu``).

G[b] = V_b^T V_b for a batch of tall-skinny matrices, f32 or bf16 in, f32
out, exactly symmetric, in one launch. Replaces ``gram_qr_pallas``
(``repro/kernels/gram_qr.py``). Call through ``ops.gram_qr``.

``plan`` is a pure function of the shapes and the card's SM count, so a
run's summation order, and its bits, depend on nothing else. Each launch
adds one to its route's count in ``ROUTE_LAUNCHES``: ``tc_bf16`` (tensor
cores), ``simt`` (CUDA cores, the ranges folded by tickets) or
``cluster`` (CUDA cores, few matrices: thread block clusters, each
summing a part of a tile pair's sums over a run of ranges through
distributed shared memory; ``plan`` takes it where ``takes_cluster``
says).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import _launch

__all__ = ["gram_qr_cuda", "Plan", "plan", "route", "ROUTE_LAUNCHES",
           "reset_route_launches"]

THREADS = 256
TC_TILE = 64
BUF_BYTES = 48 * 1024           # one staging buffer; two are in use
# A range holds at least this many bytes of V: below it a block's copy is
# all latency, and a split costs the fold's round trips more than it saves.
MIN_RANGE_BYTES = 8192
# r <= 8 (tile 8) reads rows straight into registers: a range holds up to
# this many rows a thread before a matrix is split
DIRECT_ROWS = 16
# The cluster route: blocks a cluster (16 is past the portable 8 and needs
# the card's consent, which the launch asks for; 16 read faster than 8), a
# block's rows at least, and the most tile pairs a launch (batch x pairs)
# it takes: up to 20 it read faster than the staged route at every shape of
# tools/psa_kernel_times.py --crossover qr but three, by 2-7% (PERF.md);
# at 60 (20 matrices of r = 128) it read slower to d = 4096. A launch
# takes at most SMs / C - CLUSTER_SPARE clusters: an H100's GPCs hold 7
# clusters of 16 at one block an SM (cudaOccupancyMaxActiveClusters), and
# 8, 11 or 14 a launch (two blocks on some SMs) read 25-30% slower than 7.
CLUSTER = 16
CLUSTER_MIN_ROWS = 16
CLUSTER_MAX_UNITS = 20
CLUSTER_SPARE = 1
# A tile pair's clusters split its rows only where a block would take more
# than CLUSTER_MAX_ROWS rows (their partials then folded once); the rest
# split its micro-tiles into parts, at most CLUSTER_MAX_PARTS (a diagonal
# pair's 36 micro-tiles), each part's sums written by its own cluster.
CLUSTER_MAX_ROWS = 512
CLUSTER_MAX_PARTS = 36
ROUTE_LAUNCHES: Dict[str, int] = {"tc_bf16": 0, "simt": 0, "cluster": 0}


def reset_route_launches() -> None:
    for name in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[name] = 0


def route(r: int, is_bf16: bool) -> str:
    """'tc_bf16' (tensor cores) for bf16 with r a multiple of 8 above 16,
    else 'simt' (CUDA cores; bf16 is widened to f32 as it is read). The
    plan may take 'simt' shapes to the cluster route (``takes_cluster``)."""
    return "tc_bf16" if is_bf16 and r % 8 == 0 and r > 16 else "simt"


def takes_cluster(batch: int, d: int, r: int, is_bf16: bool) -> bool:
    """Whether ``plan`` takes the cluster route: CUDA-core shapes above
    r = 8 of at most CLUSTER_MAX_UNITS tile pairs, tall enough to give
    every block of a cluster CLUSTER_MIN_ROWS rows."""
    if route(r, is_bf16) != "simt" or r <= 8:
        return False
    nt = math.ceil(r / _tile(r, "simt"))
    units = batch * nt * (nt + 1) // 2
    return units <= CLUSTER_MAX_UNITS and d >= CLUSTER * CLUSTER_MIN_ROWS


def _cluster_slots(sm_count: int) -> int:
    """Clusters of CLUSTER blocks that fit the card at once."""
    return max(1, sm_count // CLUSTER - CLUSTER_SPARE)


def _tile(r: int, how: str) -> int:
    if how == "tc_bf16":
        return TC_TILE
    return next((t for t in (8, 16, 32) if r <= t), 64)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's shape. Each tile pair of each matrix (a unit: matrix *
    pairs + tile pair) is cut into ``ranges`` ranges of ``rows_per_range``
    rows (the last one may be short): block k takes work item ``items[k] =
    (unit, c, c + 1, 1, slot, group)``, range c of the unit. ``groups``,
    ``unit_groups`` and the slots say how the ranges' partial tiles are
    added up (``_launch.fold_plan``; a unit's sole range writes G).
    Staging: ``chunk_rows`` rows at once, ``stride`` elements
    apart (r + one 16-byte unit where r is a multiple of a unit, else r:
    the flat copy), ``buf_elems`` elements a buffer."""
    route: str
    tile: int
    vec: bool
    pairs: int
    ranges: int
    rows_per_range: int
    chunk_rows: int
    stride: int
    buf_elems: int
    smem: int
    items: Tuple[Tuple[int, ...], ...]
    groups: Tuple[Tuple[int, int, int], ...]
    unit_groups: Tuple[int, ...]
    slots: int
    # the cluster route: blocks a cluster, row clusters a part (ranges =
    # cluster * clusters), parts of a tile pair's micro-tiles, and the bytes
    # of shared memory before the slices' copies (the staged and direct
    # routes: 1, 1, 1, 0)
    cluster: int = 1
    clusters: int = 1
    parts: int = 1
    recv_offset: int = 0

    @property
    def blocks(self) -> int:
        return len(self.items)

    @property
    def tickets(self) -> int:
        """Tickets a launch uses: one a slice of each tile pair (cluster
        route), else one a fold group and one a tile pair."""
        units = self.blocks // self.ranges
        if self.route == "cluster":      # units here are (tile pair, part)
            return units * self.cluster
        return len(self.groups) + units

    def block_rows(self, block: int, d: int):
        """(unit, the rows of the matrix) block ``block`` takes."""
        item = self.items[block]
        if self.route == "cluster":
            return item[0], range(*cluster_range(item[1], self.ranges, d))
        lo = item[1] * self.rows_per_range
        return item[0], range(min(lo, d), min(d, lo + self.rows_per_range))


def cluster_range(c: int, ranges: int, d: int) -> Tuple[int, int]:
    """Rows [lo, hi) of range c of a cluster route plan (csrc/gram_qr.cu
    ``gram_qr_cluster_kernel``): the matrix's groups of 8 rows cut into
    ``ranges`` runs as even as whole groups allow."""
    groups = -(-d // 8)
    return (min(d, 8 * (c * groups // ranges)),
            min(d, 8 * ((c + 1) * groups // ranges)))


@functools.lru_cache(maxsize=256)
def plan(batch: int, d: int, r: int, is_bf16: bool, sm_count: int,
         force: Optional[str] = None) -> Plan:
    """The launch for G = V^T V over (batch, d, r) on a card with
    ``sm_count`` SMs (pure: no card needed).

    Staged and direct routes: each matrix's tile pairs are cut into as many
    row ranges as one wave (one block an SM) holds, each of at least
    MIN_RANGE_BYTES of V and a multiple of 8 rows, so every range starts a
    whole number of 16-byte units into its matrix. Cluster route (where
    ``takes_cluster``): a tile pair gets as many clusters as fit the card
    at once (``_cluster_slots``) shared among the pairs, at least one (past
    7 pairs on an H100 the clusters run in turns); they cut its rows
    into K clusters of CLUSTER ranges where a range would otherwise exceed
    CLUSTER_MAX_ROWS (K no more than leaves CLUSTER_MIN_ROWS a range), and
    its micro-tiles into P parts with the rest, each part summed over all
    rows by its own K clusters. Ranges are whole groups of 8 rows, as even
    as they allow (``cluster_range``; none empty where d >= 8 ranges).
    ``force`` ('cluster', or the type's own 'simt' / 'tc_bf16')
    picks the route whatever the shapes say (the crossover's timings);
    a route that cannot take the shapes raises ValueError.
    """
    if batch < 1 or d < 1 or r < 1:
        raise ValueError(f"gram_qr kernel takes batch, d, r >= 1, got "
                         f"({batch}, {d}, {r})")
    how = route(r, is_bf16)
    tile = _tile(r, how)
    if force not in (None, how, "cluster") or (
            force == "cluster" and (how != "simt" or tile == 8)):
        raise ValueError(f"gram_qr: no {force} route at r = {r}"
                         f"{' in bf16' if is_bf16 else ''}")
    nt = math.ceil(r / tile)
    pairs = nt * (nt + 1) // 2
    units = batch * pairs
    esize = 2 if is_bf16 else 4
    unit = 16 // esize
    cluster = force == "cluster" or (
        force is None and takes_cluster(batch, d, r, is_bf16))
    if cluster:
        per_unit = max(1, _cluster_slots(sm_count) // units)
        clusters = max(1, min(per_unit,
                              math.ceil(d / (CLUSTER * CLUSTER_MAX_ROWS)),
                              d // (CLUSTER * CLUSTER_MIN_ROWS)))
        parts = max(1, min(per_unit // clusters, CLUSTER_MAX_PARTS))
        ranges = clusters * CLUSTER
        rows = 8 * math.ceil(math.ceil(d / 8) / ranges)   # the most
    else:
        min_rows = (THREADS * DIRECT_ROWS if tile == 8 else _round_up(
            max(8, math.ceil(MIN_RANGE_BYTES / (r * esize))), 8))
        ranges = max(1, min(math.ceil(d / min_rows), sm_count // units))
        rows = _round_up(math.ceil(d / ranges), 8)
        ranges = math.ceil(d / rows)
    stride = r + unit if r % unit == 0 else r
    chunk = max(16, BUF_BYTES // (stride * esize) // 16 * 16)
    chunk = min(chunk, _round_up(rows, 16))
    # the copy's first unit may start up to a unit early; columns past r
    # read up to a tile past a row's end (tile 8 stages nothing)
    buf_elems = (0 if tile == 8
                 else _round_up(chunk * stride + 2 * unit + tile, unit))
    # the tile, and then: tile 8, the 8 warps' sums; else on the CUDA cores
    # the 4 phases' sums of the 64 micro-tiles, 4 tiles' worth
    red = 4 * tile * tile * (9 if tile == 8 else 5 if how == "simt" else 1)
    smem = max(2 * buf_elems * esize, red)
    vec = how == "simt" and not is_bf16 and tile >= 32 and r % 4 == 0
    if cluster:
        # the staging buffers, or the threads' sums, then the slices'
        # copies (a tile); the row clusters' partials, a tile each, where
        # K > 1; the items only say which rows a block takes
        recv = _round_up(max(2 * buf_elems * esize,
                             4 * (THREADS + 64) * (tile // 8) ** 2), 16)
        items = tuple((u, c, c + 1, 1, -1, -1) for u in range(units)
                      for _ in range(parts) for c in range(ranges))
        return Plan("cluster", tile, vec, pairs, ranges, rows, chunk,
                    stride, buf_elems, recv + 4 * tile * tile, items, (),
                    (0,) * (units + 1),
                    units * parts * clusters if clusters > 1 else 0,
                    CLUSTER, clusters, parts, recv)
    items = tuple((u, c, c + 1, 1) for u in range(units)
                  for c in range(ranges))
    items, groups, unit_groups, slots = _launch.fold_plan(items, units)
    return Plan(how, tile, vec, pairs, ranges, rows, chunk, stride,
                buf_elems, smem, items, groups, unit_groups, slots)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/gram_qr.cu) with its C signatures set."""
    lib.gram_qr_launch.argtypes = [ctypes.c_void_p] * 7
    lib.gram_qr_launch.restype = ctypes.c_int
    lib.gram_qr_cluster_occupancy.argtypes = [ctypes.c_void_p] * 2
    lib.gram_qr_cluster_occupancy.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    from . import _build
    return _typed(_build.load("gram_qr"))


@functools.lru_cache(maxsize=64)
def _device_plan(device_index: int, batch: int, d: int, r: int,
                 is_bf16: bool, force: Optional[str] = None):
    """The plan for this card, its tables as one int32 tensor on it, and
    the launch's host parameters (csrc/gram_qr.cu ``gram_qr_launch``) as
    one ctypes array."""
    p = plan(batch, d, r, is_bf16, _launch.card(device_index)[0], force)
    table = _launch.plan_table(device_index, p.items, p.groups,
                               p.unit_groups)
    values = (int(is_bf16), batch, d, r, p.tile, int(p.route == "tc_bf16"),
              int(p.vec), p.pairs, p.ranges, p.rows_per_range,
              p.chunk_rows, p.stride, p.buf_elems, p.blocks,
              p.smem, len(p.groups), 6 * len(p.items),
              6 * len(p.items) + 3 * len(p.groups), p.cluster, p.clusters,
              p.parts, p.recv_offset)
    return p, table, (ctypes.c_int * len(values))(*values)


def cluster_occupancy(batch: int, d: int, r: int, is_bf16: bool = False,
                      device_index: int = 0) -> int:
    """How many clusters of the cluster route's plan for (batch, d, r) the
    card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    _, _, params = _device_plan(device_index, batch, d, r, is_bf16,
                                "cluster")
    out = ctypes.c_int(0)
    with _launch.on_device(device_index):
        err = _lib().gram_qr_cluster_occupancy(params, ctypes.byref(out))
    _launch.raise_on_error(err, "gram_qr_cluster_occupancy")
    return out.value


# (device, stream) -> (tickets, partial scratch), see _launch.workspace
_WORK: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def gram_qr_cuda(v: torch.Tensor, route: Optional[str] = None
                 ) -> torch.Tensor:
    """v: (B, d, r) f32 or bf16, contiguous on a CUDA device -> (B, r, r)
    f32. ``route`` forces the plan's route (``plan``'s ``force``)."""
    dev = v.device
    _launch.check(v, "v", (torch.float32, torch.bfloat16), 3, dev)
    batch, d, r = v.shape
    g = torch.empty((batch, r, r), dtype=torch.float32, device=dev)
    if batch == 0 or r == 0:
        return g
    if d == 0:
        return g.zero_()
    if v.data_ptr() % 16:            # a view: the 16-byte copies need this
        v = v.clone()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    p, table, params = _device_plan(index, batch, d, r,
                                    v.dtype == torch.bfloat16, route)
    stream = _launch.stream(dev)
    tickets, partial = _launch.workspace(
        _WORK, index, stream.value, p.tickets, p.slots * p.tile * p.tile)
    with _launch.on_device(index):
        err = _lib().gram_qr_launch(
            v.data_ptr(), g.data_ptr(), partial.data_ptr(),
            tickets.data_ptr(), table.data_ptr(), params, stream)
    _launch.raise_on_error(err, "gram_qr_launch")
    ROUTE_LAUNCHES[p.route] += 1
    return g
