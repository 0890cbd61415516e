"""CUDA wrapper for the Hopper Gram kernel of CholeskyQR (``csrc/gram_qr.cu``).

G[b] = V_b^T V_b for a batch of tall-skinny matrices, f32 or bf16 in, f32
out, exactly symmetric, in one launch. Replaces ``gram_qr_pallas``
(``repro/kernels/gram_qr.py``). Call through ``ops.gram_qr``.

``plan`` is a pure function of the shapes and the card's SM count, so a
run's summation order, and its bits, depend on nothing else. Each launch
adds one to its route's count in ``ROUTE_LAUNCHES``: ``tc_bf16`` (tensor
cores) or ``simt`` (CUDA cores).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Tuple

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
ROUTE_LAUNCHES: Dict[str, int] = {"tc_bf16": 0, "simt": 0}


def reset_route_launches() -> None:
    for name in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[name] = 0


def route(r: int, is_bf16: bool) -> str:
    """'tc_bf16' (tensor cores) for bf16 with r a multiple of 8 above 16,
    else 'simt' (CUDA cores; bf16 is widened to f32 as it is read)."""
    return "tc_bf16" if is_bf16 and r % 8 == 0 and r > 16 else "simt"


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

    @property
    def blocks(self) -> int:
        return len(self.items)

    def block_rows(self, block: int, d: int):
        """(unit, the rows of the matrix) block ``block`` takes."""
        item = self.items[block]
        lo = item[1] * self.rows_per_range
        return item[0], range(min(lo, d), min(d, lo + self.rows_per_range))


@functools.lru_cache(maxsize=256)
def plan(batch: int, d: int, r: int, is_bf16: bool, sm_count: int) -> Plan:
    """The launch for G = V^T V over (batch, d, r) on a card with
    ``sm_count`` SMs (pure: no card needed).

    Each matrix's tile pairs are cut into as many row ranges as one wave
    (one block an SM) holds, each of at least MIN_RANGE_BYTES of V and a
    multiple of 8 rows, so every range starts a whole number of 16-byte
    units into its matrix.
    """
    if batch < 1 or d < 1 or r < 1:
        raise ValueError(f"gram_qr kernel takes batch, d, r >= 1, got "
                         f"({batch}, {d}, {r})")
    how = route(r, is_bf16)
    tile = _tile(r, how)
    nt = math.ceil(r / tile)
    pairs = nt * (nt + 1) // 2
    esize = 2 if is_bf16 else 4
    unit = 16 // esize
    min_rows = (THREADS * DIRECT_ROWS if tile == 8 else _round_up(
        max(8, math.ceil(MIN_RANGE_BYTES / (r * esize))), 8))
    ranges = max(1, min(math.ceil(d / min_rows),
                        sm_count // (batch * pairs)))
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
    units = batch * pairs
    items = tuple((u, c, c + 1, 1) for u in range(units)
                  for c in range(ranges))
    items, groups, unit_groups, slots = _launch.fold_plan(items, units)
    return Plan(how, tile, how == "simt" and not is_bf16 and tile >= 32
                and r % 4 == 0, pairs, ranges, rows, chunk, stride,
                buf_elems, smem, items, groups, unit_groups, slots)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/gram_qr.cu) with its C signature set."""
    lib.gram_qr_launch.argtypes = [ctypes.c_void_p] * 7
    lib.gram_qr_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    from . import _build
    return _typed(_build.load("gram_qr"))


@functools.lru_cache(maxsize=64)
def _device_plan(device_index: int, batch: int, d: int, r: int,
                 is_bf16: bool):
    """The plan for this card, its tables as one int32 tensor on it, and
    the launch's host parameters (csrc/gram_qr.cu ``gram_qr_launch``) as
    one ctypes array."""
    p = plan(batch, d, r, is_bf16, _launch.card(device_index)[0])
    table = _launch.plan_table(device_index, p.items, p.groups,
                               p.unit_groups)
    values = (int(is_bf16), batch, d, r, p.tile, int(p.route == "tc_bf16"),
              int(p.vec), p.pairs, p.ranges, p.rows_per_range,
              p.chunk_rows, p.stride, p.buf_elems, p.blocks,
              p.smem, len(p.groups), 6 * len(p.items),
              6 * len(p.items) + 3 * len(p.groups))
    return p, table, (ctypes.c_int * len(values))(*values)


# (device, stream) -> (tickets, partial scratch), see _launch.workspace
_WORK: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def gram_qr_cuda(v: torch.Tensor) -> torch.Tensor:
    """v: (B, d, r) f32 or bf16, contiguous on a CUDA device -> (B, r, r)
    f32."""
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
                                    v.dtype == torch.bfloat16)
    stream = _launch.stream(dev)
    tickets, partial = _launch.workspace(
        _WORK, index, stream.value, len(p.groups) + batch * p.pairs,
        p.slots * p.tile * p.tile)
    with _launch.on_device(index):
        err = _lib().gram_qr_launch(
            v.data_ptr(), g.data_ptr(), partial.data_ptr(),
            tickets.data_ptr(), table.data_ptr(), params, stream)
    _launch.raise_on_error(err, "gram_qr_launch")
    ROUTE_LAUNCHES[p.route] += 1
    return g
