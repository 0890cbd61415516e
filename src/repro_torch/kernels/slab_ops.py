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

Both have a second route for stacks of many small blocks (B-DOT's 4 x
4,096 grid of 196 x 16 blocks), the packed kernel: persistent blocks walk
contiguous ranges of grid blocks, streamed whole, several to a ring stage,
by 1-D bulk copies (or 4-byte cp.async where a block's bytes or start are
not 16-byte multiples). ``packed_plan`` picks the route from the shapes
alone: packed where n <= ``PACKED_MAX_N`` and a ring of two stages fits,
else the tiled kernels above. The tq kernel counts its launches by route in
``TQ_ROUTE_LAUNCHES`` ("tiled", "packed", "packed_cp_async"), the apply
kernel in ``ROUTE_LAUNCHES`` ("tma" and "cp_async" for the tiled kernel's
staging, "packed", "packed_cp_async").

``apply_plan`` and ``packed_plan`` are pure functions of the shapes and the
card's SM count and shared-memory limit. Call through
``ops.batched_slab_tq`` / ``batched_slab_apply`` / ``grid_block_tq`` /
``grid_block_apply``.
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
           "TQ_ROUTE_LAUNCHES", "reset_route_launches", "apply_route",
           "ApplyPlan", "apply_plan", "apply_smem_bytes", "PackedPlan",
           "packed_plan", "packed_layout", "packed_smem_bytes",
           "PACKED_MAX_N"]

MAX_R = 64                      # largest r the kernels instantiate
WARPS = 8                       # warps of an apply block
APPLY_VALS = 64                 # rows a warp x r_max: sums in registers
MAX_STAGES = 8
STATIC_SMEM = 128               # the kernel's static shared memory, rounded up
_TILE_COLS = (256, 128, 64, 32)
_MIN_STAGES = 3                 # the widest tile whose ring holds this many
ROUTE_LAUNCHES: Dict[str, int] = {"tma": 0, "cp_async": 0, "packed": 0,
                                  "packed_cp_async": 0}
TQ_ROUTE_LAUNCHES: Dict[str, int] = {"tiled": 0, "packed": 0,
                                     "packed_cp_async": 0}
# The packed route takes n up to these: the crossover with the tiled
# kernels, timed by tools/psa_kernel_times.py --crossover on an H100 at
# d = 196, r = 5 and ~200 MB of X (PERF.md has the readings). tq: packed
# 0.0807 ms against tiled 0.101 at n = 64, 0.0830 against 0.0781 at 128;
# apply: packed 0.166 against tiled 0.287 at n = 128, and the packed
# kernel takes no n past 128 at d = 196 (a block of 256 columns does not
# fit a ring of two stages).
PACKED_MAX_N: Dict[str, int] = {"tq": 64, "apply": 128}
PACKED_STAGE_BYTES = 32 * 1024  # a stage holds at least this where it can
PACKED_MAX_STAGES = 8


def reset_route_launches() -> None:
    for counts in (ROUTE_LAUNCHES, TQ_ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0


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


def packed_smem_bytes(kernel: str, blocks_per_stage: int, d: int, n: int,
                      r: int, stages: int) -> int:
    """Dynamic shared memory of one packed block (the kernel's
    ``packed_smem_bytes``): 128 bytes of alignment slack, ``stages`` stages
    of ``blocks_per_stage`` grid blocks of X (and, for apply, their chunks
    of S) padded to 128 bytes, tq's two Q slots (d rows of r floats padded
    to float4s), one mbarrier a stage."""
    per = d * n + (n * r if kernel == "apply" else 0)
    stage = -(-4 * blocks_per_stage * per // 128) * 128
    q = 2 * d * 16 * -(-r // 4) if kernel == "tq" else 0
    return 128 + stages * stage + q + 8 * stages


@dataclasses.dataclass(frozen=True)
class PackedPlan:
    """The route of one tq or apply launch and, for the packed route, its
    work: persistent block g takes grid blocks ``starts[g]: starts[g + 1]``
    (b = i * J + j), ``blocks_per_stage`` of them a ring stage (at most J,
    so a stage meets at most two grid rows), ``row_slices`` tasks a grid
    block (apply: where a stage holds fewer blocks than there are warps),
    column units of ``vec`` floats, ``upl`` units a lane (apply), and
    ``unit_lanes`` lanes a row (apply) or a row phase (tq) for them: a tq
    task is a grid block's group of ``unit_lanes`` units.
    ``q_stagings`` counts tq's stagings of a Q row: one for each grid row a
    range meets. A "tiled" plan carries only its route."""
    route: str
    vec: int = 0
    upl: int = 0
    unit_lanes: int = 0
    blocks_per_stage: int = 0
    row_slices: int = 0
    stages: int = 0
    grid: int = 0
    smem: int = 0
    starts: Tuple[int, ...] = ()
    q_stagings: int = 0


TILED = PackedPlan("tiled")


@functools.lru_cache(maxsize=256)
def packed_layout(kernel: str, blocks: int, J: int, d: int, n: int, r: int,
                  sm_count: int, smem_limit: int):
    """The packed route's plan for these shapes whatever n, or None where
    the packed kernel cannot take them (pure: no card needed).

    Units are float4s of columns where n % 4 == 0 and r <= 16, else single
    columns; apply holds its units of S in registers, one unit a lane (two
    for float4s, so n <= 256; n <= 32 for single columns). A stage holds
    a grid block for every warp, more where that is under 32 KB, at most
    J; the ring is the deepest of 2-8 stages that fits, and two must. Where
    a stage holds fewer blocks than warps, tq cuts a block's units into
    narrower groups and apply a block's rows into slices. The grid blocks
    are cut into one contiguous range a persistent block, at most one block
    an SM.
    """
    if kernel not in ("tq", "apply"):
        raise ValueError(f"kernel is 'tq' or 'apply', got {kernel!r}")
    _check_r(r, f"slab-{kernel}")
    if min(blocks, J, d, n) < 1 or blocks % J:
        raise ValueError(f"no packed plan for {blocks} blocks, J={J}, "
                         f"d={d}, n={n}")
    vec = 4 if n % 4 == 0 and r <= 16 else 1
    units = -(-n // vec)
    lanes = min(32, 1 << (units - 1).bit_length())
    upl = -(-units // 32) if kernel == "apply" else 1
    if upl > (2 if vec == 4 else 1):
        return None
    block_bytes = 4 * (d * n + (n * r if kernel == "apply" else 0))
    want = WARPS * max(1, -(-PACKED_STAGE_BYTES // (WARPS * block_bytes)))
    grid = min(sm_count, blocks)
    g = max(1, min(want, J, -(-blocks // grid)))
    budget = smem_limit - STATIC_SMEM
    while g > 1 and packed_smem_bytes(kernel, g, d, n, r, 2) > budget:
        g -= 1
    if packed_smem_bytes(kernel, g, d, n, r, 2) > budget:
        return None
    stages = max(s for s in range(2, PACKED_MAX_STAGES + 1)
                 if packed_smem_bytes(kernel, g, d, n, r, s) <= budget)
    if kernel == "tq":
        # narrower groups of units (more row phases a warp) until every
        # warp has a task
        while lanes > 1 and g * -(-units // lanes) < WARPS:
            lanes //= 2
        slices = 1
    else:
        slices = max(1, min(d, WARPS // g))
    starts = tuple(k * blocks // grid for k in range(grid + 1))
    stagings = (sum((b1 - 1) // J - b0 // J + 1
                    for b0, b1 in zip(starts, starts[1:]))
                if kernel == "tq" else 0)
    return PackedPlan("packed", vec, upl, lanes, g, slices, stages, grid,
                      packed_smem_bytes(kernel, g, d, n, r, stages), starts,
                      stagings)


def packed_plan(kernel: str, blocks: int, J: int, d: int, n: int, r: int,
                sm_count: int, smem_limit: int) -> PackedPlan:
    """The route of a tq (``kernel="tq"``) or apply launch over ``blocks``
    grid blocks of (d, n), J grid columns, on a card with ``sm_count`` SMs
    and ``smem_limit`` bytes of shared memory a block (pure: no card
    needed): packed where n <= PACKED_MAX_N[kernel] and ``packed_layout``
    takes the shapes, else tiled."""
    p = packed_layout(kernel, blocks, J, d, n, r, sm_count, smem_limit)
    return p if p is not None and n <= PACKED_MAX_N[kernel] else TILED


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
        lib.slab_packed_launch.argtypes = [i] + [vp] * 4 + [i] * 14 + [vp]
        lib.slab_packed_launch.restype = i
        lib.slab_packed_smem_bytes.argtypes = [i] * 6
        lib.slab_packed_smem_bytes.restype = ctypes.c_size_t
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


@functools.lru_cache(maxsize=64)
def _device_packed_plan(device_index: int, kernel: str, blocks: int, J: int,
                        d: int, n: int, r: int, route=None):
    """The route for this card (``route`` "packed" or "tiled" overrides the
    planner's choice; "packed" raises where the packed kernel cannot take
    the shapes) and, for the packed route, its ``starts`` as an int32
    tensor on the card and a pointer to it."""
    card = _launch.card(device_index)
    if route is None:
        p = packed_plan(kernel, blocks, J, d, n, r, *card)
    elif route == "packed":
        p = packed_layout(kernel, blocks, J, d, n, r, *card)
        if p is None:
            raise ValueError(f"the packed {kernel} kernel does not take "
                             f"{blocks} blocks of ({d}, {n}), r = {r}")
    elif route == "tiled":
        p = TILED
    else:
        raise ValueError(f"route is 'packed' or 'tiled', got {route!r}")
    if p.route != "packed":
        return p, None, None
    table = _launch.plan_table(device_index, p.starts)
    return p, table, _launch.table_pointers(table, p.grid + 1)[0]


def _launch_packed(kernel: str, p: PackedPlan, starts, x: torch.Tensor,
                   y: torch.Tensor, out: torch.Tensor, J: int, index: int,
                   counts: Dict[str, int]) -> None:
    """One packed launch; adds one to its staging route in ``counts``."""
    blocks, d, n = x.shape
    r = y.shape[2]
    bulk = ((d * n) % 4 == 0 and x.data_ptr() % 16 == 0
            and y.data_ptr() % 16 == 0
            and (kernel == "tq" or (n * r) % 4 == 0))
    with _launch.on_device(index):
        err = _lib().slab_packed_launch(
            int(kernel == "apply"), _launch.ptr(x), _launch.ptr(y),
            _launch.ptr(out), starts, blocks, J, d, n, r,
            p.blocks_per_stage, p.row_slices, p.unit_lanes, p.stages,
            p.grid, p.smem, int(bulk), p.vec, p.upl,
            _launch.stream(x.device))
    _launch.raise_on_error(err, "slab_packed_launch")
    counts["packed" if bulk else "packed_cp_async"] += 1


# (device, stream) -> (tickets, partial scratch), see _launch.workspace
_WORK: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _check_r(r: int, what: str) -> None:
    if not 1 <= r <= MAX_R:
        raise ValueError(f"{what} kernel takes 1 <= r <= {MAX_R}, got {r}")


def slab_tq_cuda(x: torch.Tensor, q: torch.Tensor, j_cols: int,
                 route=None) -> torch.Tensor:
    """x: (B, d, n) f32, q: (B // j_cols, d, r) f32, both contiguous on one
    CUDA device -> Z: (B, n, r) f32 with Z[b] = x[b]^T q[b // j_cols].
    ``route`` ("packed" or "tiled") overrides ``packed_plan``'s choice."""
    dev = x.device
    _launch.check(x, "x", (torch.float32,), 3, dev)
    _launch.check(q, "q", (torch.float32,), 3, dev)
    blocks, d, n = x.shape
    r = q.shape[2]
    if j_cols < 1 or blocks % j_cols or q.shape[:2] != (blocks // j_cols, d):
        raise ValueError(f"shapes do not align: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, {j_cols} grid columns")
    _check_r(r, "slab-tq")
    z = torch.empty((blocks, n, r), dtype=torch.float32, device=dev)
    if n == 0 or blocks == 0:
        return z
    if d == 0:
        return z.zero_()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    p, _, starts = _device_packed_plan(index, "tq", blocks, j_cols, d, n, r,
                                       route)
    if p.route == "packed":
        _launch_packed("tq", p, starts, x, q, z, j_cols, index,
                       TQ_ROUTE_LAUNCHES)
        return z
    if blocks > _launch.MAX_GRID_Y:
        raise ValueError(f"the tiled slab-tq kernel takes 1.."
                         f"{_launch.MAX_GRID_Y} blocks, got {blocks}")
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.slab_tq_launch(_launch.ptr(x), _launch.ptr(q),
                                 _launch.ptr(z), blocks, j_cols, d, n, r,
                                 _launch.stream(dev))
    _launch.raise_on_error(err, "slab_tq_launch")
    TQ_ROUTE_LAUNCHES["tiled"] += 1
    return z


def slab_apply_cuda(x: torch.Tensor, s: torch.Tensor, j_cols: int,
                    route=None) -> torch.Tensor:
    """x: (B, d, n) f32, s: (j_cols, n, r) f32 with j_cols dividing B, both
    contiguous on one CUDA device -> V: (B, d, r) f32 with
    V[b] = x[b] s[b % j_cols]. ``route`` ("packed" or "tiled") overrides
    ``packed_plan``'s choice."""
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
    pk, _, starts = _device_packed_plan(index, "apply", blocks, j_cols, d, n,
                                        r, route)
    if pk.route == "packed":
        _launch_packed("apply", pk, starts, x, s, v, j_cols, index,
                       ROUTE_LAUNCHES)
        return v
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
