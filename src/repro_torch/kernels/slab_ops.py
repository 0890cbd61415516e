"""CUDA wrappers for the Hopper slab and grid kernels (``csrc/slab_ops.cu``).

Two kernels over a stack of B = I * J blocks of X, each (d, n):

* ``slab_tq_cuda``: Z[b] = X_b^T Q[b // J], one launch. Replaces
  ``batched_slab_tq_pallas`` ((I, J) = (N, 1)) and ``grid_block_tq_pallas``
  (``repro/kernels/slab_ops.py``).
* ``slab_apply_cuda``: V[b] = X_b S[b % J], one launch: a persistent grid
  streams X and S through a ring of shared-memory tiles (TMA and bulk
  copies, or cp.async where n % 4 != 0), and the last block of each (block,
  row chunk) sums its partials in a fixed order. Replaces
  ``batched_slab_apply_pallas`` ((I, J) = (1, N)) and
  ``grid_block_apply_pallas``. Each launch adds one to its staging route's
  count in ``ROUTE_LAUNCHES``.

``apply_plan`` is a pure function of the shapes and the card's SM count and
shared-memory limit. Call through ``ops.batched_slab_tq`` /
``batched_slab_apply`` / ``grid_block_tq`` / ``grid_block_apply``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch

from . import _launch

__all__ = ["slab_tq_cuda", "slab_apply_cuda", "MAX_R", "ROUTE_LAUNCHES",
           "reset_route_launches", "apply_route", "ApplyPlan", "apply_plan",
           "apply_smem_bytes"]

MAX_R = 64                      # largest r the kernels instantiate
WARPS = 8                       # warps of an apply block
APPLY_VALS = 64                 # rows a warp x r_max: sums in registers
MAX_STAGES = 8
STATIC_SMEM = 128               # the kernel's static shared memory, rounded up
_TILE_COLS = (256, 128, 64, 32)
_MIN_STAGES = 3                 # the widest tile whose ring holds this many
ROUTE_LAUNCHES: Dict[str, int] = {"tma": 0, "cp_async": 0}


def reset_route_launches() -> None:
    for name in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[name] = 0


def apply_route(x: torch.Tensor, s: torch.Tensor) -> str:
    """'tma' where a tensor map and bulk copies can take x and s (n % 4 ==
    0, both 16-byte aligned), else 'cp_async'."""
    aligned = (x.shape[-1] % 4 == 0 and x.data_ptr() % 16 == 0
               and s.data_ptr() % 16 == 0)
    return "tma" if aligned else "cp_async"


def apply_smem_bytes(rows: int, cols: int, r: int, stages: int) -> int:
    """Dynamic shared memory of one apply block (the kernel's
    ``apply_smem_bytes``): alignment slack, ``stages`` stages of an X tile
    (rows x cols) and an S chunk (cols x r) padded to 1024 bytes, one
    mbarrier a stage."""
    stage = math.ceil(4 * cols * (rows + r) / 1024) * 1024
    return 1024 + stages * stage + 8 * stages


@dataclasses.dataclass(frozen=True)
class ApplyPlan:
    """One apply launch: row chunks of ``rows`` rows (``rpw`` a warp), tiles
    of ``cols`` columns, the ring depth, the grid and its work items.

    A unit is (block b, row chunk c), numbered b * chunks + c.
    ``items[k] = (unit, first tile, end tile, tile step, slot, group)`` in
    the order the blocks walk them: block g takes ``block_items[g]:
    block_items[g + 1]``. ``groups``, ``unit_groups`` and the slots say how
    the partial sums are added up (``_launch.fold_plan``); ``slots`` is the
    scratch's size in partials.
    """
    chunks: int
    rows: int
    rpw: int
    cols: int
    stages: int
    grid: int
    smem: int
    items: Tuple[Tuple[int, ...], ...]
    block_items: Tuple[int, ...]
    groups: Tuple[Tuple[int, int, int], ...]
    unit_groups: Tuple[int, ...]
    slots: int


@functools.lru_cache(maxsize=256)
def apply_plan(blocks: int, d: int, n: int, r: int, sm_count: int,
               smem_limit: int) -> ApplyPlan:
    """The apply launch for these shapes on a card with ``sm_count`` SMs and
    ``smem_limit`` bytes of shared memory a block (pure: no card needed).

    The rows of a block are cut into the fewest chunks of at most 8 warps x
    64 / r_max rows, dealt out evenly to the warps (d = 55: 7 rows a warp);
    the tile is the widest of 256, 128, 64, 32 columns whose ring holds
    three stages (else two). The (unit, tile) pairs, unit-major, are cut into
    one contiguous range a block, at most one block an SM.
    """
    r_max = next((m for m in (8, 16, 32, 64) if r <= m), None)
    if r_max is None or r < 1:
        raise ValueError(f"slab-apply kernel takes 1 <= r <= {MAX_R}, got {r}")
    per_warp = APPLY_VALS // r_max
    chunks = math.ceil(d / (WARPS * per_warp))
    rows = math.ceil(d / chunks)
    rpw = math.ceil(rows / WARPS)
    budget = smem_limit - STATIC_SMEM

    def depth(cols):
        return max((s for s in range(2, MAX_STAGES + 1)
                    if apply_smem_bytes(rows, cols, r, s) <= budget),
                   default=0)

    cols = next((c for c in _TILE_COLS if depth(c) >= _MIN_STAGES), None)
    if cols is None:
        cols = next((c for c in _TILE_COLS if depth(c) >= 2), None)
    if cols is None:
        raise ValueError(f"slab-apply: r={r} needs more shared memory than a "
                         f"block has ({smem_limit} bytes)")
    stages = depth(cols)
    per_unit = math.ceil(n / cols)
    units = blocks * chunks
    items, block_items = _launch.contiguous_items(
        units, per_unit, min(sm_count, units * per_unit))
    items, groups, unit_groups, slots = _launch.fold_plan(items, units)
    return ApplyPlan(chunks, rows, rpw, cols, stages, len(block_items) - 1,
                     apply_smem_bytes(rows, cols, r, stages), items,
                     tuple(block_items), groups, unit_groups, slots)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from . import _build
    return _typed(_build.load("slab_ops"))


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/slab_ops.cu) with its C signatures set."""
    if not getattr(lib, "_repro_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.slab_tq_launch.argtypes = [vp] * 3 + [i] * 5 + [vp]
        lib.slab_tq_launch.restype = i
        lib.slab_apply_launch.argtypes = [vp] * 9 + [i] * 14 + [vp]
        lib.slab_apply_launch.restype = i
        lib.slab_apply_smem_bytes.argtypes = [i, i, i, i]
        lib.slab_apply_smem_bytes.restype = ctypes.c_size_t
        lib._repro_typed = True
    return lib


@functools.lru_cache(maxsize=64)
def _device_apply_plan(device_index: int, blocks: int, d: int, n: int,
                       r: int):
    """The plan for this card, its tables as one int32 tensor on it, and
    the kernel's pointers to them."""
    p = apply_plan(blocks, d, n, r, *_launch.card(device_index))
    table = _launch.plan_table(device_index, p.items, p.block_items,
                               p.groups, p.unit_groups)
    return p, table, _launch.table_pointers(
        table, 6 * len(p.items), p.grid + 1, 3 * len(p.groups),
        blocks * p.chunks + 1)


# (device, stream) -> (tickets, partial scratch), see _launch.workspace
_WORK: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _check_r(r: int, what: str) -> None:
    if not 1 <= r <= MAX_R:
        raise ValueError(f"{what} kernel takes 1 <= r <= {MAX_R}, got {r}")


def slab_tq_cuda(x: torch.Tensor, q: torch.Tensor,
                 j_cols: int) -> torch.Tensor:
    """x: (B, d, n) f32, q: (B // j_cols, d, r) f32, both contiguous on one
    CUDA device -> Z: (B, n, r) f32 with Z[b] = x[b]^T q[b // j_cols]."""
    dev = x.device
    _launch.check(x, "x", (torch.float32,), 3, dev)
    _launch.check(q, "q", (torch.float32,), 3, dev)
    blocks, d, n = x.shape
    r = q.shape[2]
    if j_cols < 1 or blocks % j_cols or q.shape[:2] != (blocks // j_cols, d):
        raise ValueError(f"shapes do not align: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, {j_cols} grid columns")
    _check_r(r, "slab-tq")
    if not 1 <= blocks <= _launch.MAX_GRID_Y:
        raise ValueError(f"slab-tq kernel takes 1..{_launch.MAX_GRID_Y} "
                         f"blocks, got {blocks}")
    z = torch.empty((blocks, n, r), dtype=torch.float32, device=dev)
    if n == 0:
        return z
    if d == 0:
        return z.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.slab_tq_launch(_launch.ptr(x), _launch.ptr(q),
                                 _launch.ptr(z), blocks, j_cols, d, n, r,
                                 _launch.stream(dev))
    _launch.raise_on_error(err, "slab_tq_launch")
    return z


def slab_apply_cuda(x: torch.Tensor, s: torch.Tensor,
                    j_cols: int) -> torch.Tensor:
    """x: (B, d, n) f32, s: (j_cols, n, r) f32 with j_cols dividing B, both
    contiguous on one CUDA device -> V: (B, d, r) f32 with
    V[b] = x[b] s[b % j_cols]."""
    dev = x.device
    _launch.check(x, "x", (torch.float32,), 3, dev)
    _launch.check(s, "s", (torch.float32,), 3, dev)
    blocks, d, n = x.shape
    r = s.shape[2]
    if j_cols < 1 or blocks % j_cols or s.shape[:2] != (j_cols, n):
        raise ValueError(f"shapes do not align: x {tuple(x.shape)}, s "
                         f"{tuple(s.shape)}")
    _check_r(r, "slab-apply")
    v = torch.empty((blocks, d, r), dtype=torch.float32, device=dev)
    if d == 0 or blocks == 0:
        return v
    if n == 0:
        return v.zero_()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    p, _, tables = _device_apply_plan(index, blocks, d, n, r)
    stream = _launch.stream(dev)
    tickets, partial = _launch.workspace(
        _WORK, index, stream.value, len(p.groups) + blocks * p.chunks,
        p.slots * p.rows * r)
    how = apply_route(x, s)
    with _launch.on_device(index):
        err = _lib().slab_apply_launch(
            _launch.ptr(x), _launch.ptr(s), _launch.ptr(partial),
            _launch.ptr(v), _launch.ptr(tickets), *tables, blocks, j_cols, d,
            n, r, p.chunks, p.rows, p.rpw, p.cols, p.stages, p.grid, p.smem,
            int(how == "tma"), len(p.groups), stream)
    _launch.raise_on_error(err, "slab_apply_launch")
    ROUTE_LAUNCHES[how] += 1
    return v
