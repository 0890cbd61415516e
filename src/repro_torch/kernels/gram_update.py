"""CUDA wrapper for the Hopper gram-apply kernel (``csrc/gram_update.cu``).

V[i] = X_i (X_i^T Q_i) / n_i for all nodes in one launch: a persistent grid
streams X through a ring of shared-memory tiles (TMA, or cp.async where
n % 4 != 0), and the last block of each node sums the node's partials in a
fixed order. Replaces ``batched_gram_apply_pallas`` and, as its N = 1 launch,
``gram_apply_pallas`` (``repro/kernels/gram_update.py``). Call through
``ops.batched_gram_apply`` / ``ops.gram_apply``.

``plan`` is a pure function of the shapes and the card's SM count and
shared-memory limit, so a run's summation order, and its bits, depend on
nothing else. Each launch adds one to its staging route's count in
``ROUTE_LAUNCHES``.

Nodes of few samples (sdot_sparse's 4,096 nodes of 784 x 16) take the
packed route: a node whole in a ring stage, X_i and Q_i each one bulk copy,
z and V computed from the stage by one block (``packed_plan``, as pure as
``plan``). It is chosen where n <= PACKED_MAX_N (the two routes' crossover,
``tools/psa_kernel_times.py --crossover``), d n and d r are multiples of 4
and a ring of two stages fits; else, or where x or q is not 16-byte
aligned, the stream above runs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch

from . import _launch

__all__ = ["batched_gram_apply_cuda", "MAX_R", "ROUTE_LAUNCHES",
           "reset_route_launches", "route", "Plan", "plan", "smem_bytes",
           "PackedPlan", "packed_layout", "packed_plan", "packed_smem_bytes",
           "PACKED_MAX_N"]

MAX_R = 64                      # largest r the kernel instantiates
THREADS = 256                   # a block; thread t owns rows t, t + 256, ...
BOX_ROWS = 256                  # rows of a TMA box
RED_VALS = 64                   # values a column batch reduces (CB * r_max)
MAX_STAGES = 8
MAX_ROW_VALS = 128              # rows a thread x r_max: Q and V in registers
STATIC_SMEM = 128               # the kernel's static shared memory, rounded up
_TILE_COLS = (32, 16, 8)        # 128-, 64-, 32-byte row segments, widest first
_MIN_STAGES = 3                 # the widest tile whose ring holds this many
# the packed route's largest n: its crossover with the stream, measured to
# n = 28 (at 4,096 nodes the packed route is faster at every n where a ring
# fits, 0.286 against 0.341 ms at n = 28, d = 784, r = 5; at 20 nodes, a few
# us a launch, the two are within 1.2 us from n = 20;
# tools/psa_kernel_times.py --crossover gram, PERF.md)
PACKED_MAX_N = 28
PACKED_MAX_STAGES = 8
PACKED_MAX_COLS = 32            # n the packed kernel takes (z' in registers)
PACKED_WARPS = 8                # a packed block's consumer warps
PACKED_ALIGN = 128              # a packed stage's alignment in shared memory
ROUTE_LAUNCHES: Dict[str, int] = {"tma": 0, "cp_async": 0, "packed": 0}


def reset_route_launches() -> None:
    for name in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[name] = 0


def route(x: torch.Tensor) -> str:
    """'tma' where a tensor map can take x (rows 16-byte aligned), else
    'cp_async'."""
    aligned = x.shape[-1] % 4 == 0 and x.data_ptr() % 16 == 0
    return "tma" if aligned else "cp_async"


_staging_route = route          # the wrapper's ``route`` argument shadows it


def smem_bytes(d: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of one block (the kernel's ``smem_bytes``): the
    1024-byte alignment slack, ``stages`` tiles of ceil(d / 256) boxes each
    padded to 1024 bytes, the warps' sums and z, one mbarrier a stage."""
    box_rows = min(d, BOX_ROWS)
    boxes = math.ceil(d / box_rows)
    box_stride = math.ceil(box_rows * bn * 4 / 1024) * 1024
    return (1024 + stages * boxes * box_stride
            + 4 * (THREADS // 32 * RED_VALS + RED_VALS) + 8 * stages)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's shape: the instantiation (``r_max``, ``rows``), the tile
    (``bn`` columns) and ring depth, the grid and its work items.

    ``items[k] = (node, first tile, end tile, tile step, slot, group)`` in
    the order the blocks walk them: block b takes items
    ``block_items[b]:block_items[b + 1]``. ``groups``, ``node_groups`` and
    the slots say how the partial sums are added up
    (``_launch.fold_plan``); ``slots`` is the scratch's size in partials.
    """
    r_max: int
    rows: int
    bn: int
    stages: int
    grid: int
    smem: int
    items: Tuple[Tuple[int, ...], ...]
    block_items: Tuple[int, ...]
    groups: Tuple[Tuple[int, int, int], ...]
    node_groups: Tuple[int, ...]
    slots: int


@functools.lru_cache(maxsize=256)
def plan(nodes: int, d: int, n: int, r: int, sm_count: int,
         smem_limit: int) -> Plan:
    """The launch for these shapes on a card with ``sm_count`` SMs and
    ``smem_limit`` bytes of shared memory a block (pure: no card needed).

    The tile is the widest of 32, 16 and 8 columns whose ring holds three
    stages (else two). At most one block an SM. Where the nodes fit on the
    SMs, each node's tiles are dealt round-robin to SMs // N blocks of its
    own, so that blocks running side by side read neighbouring columns of
    the same rows; else the (node, tile) pairs, node-major, are cut into one
    contiguous range a block.
    """
    r_max = next((m for m in (8, 16, 32, 64) if r <= m), None)
    if r_max is None or r < 1:
        raise ValueError(f"gram-apply kernel takes 1 <= r <= {MAX_R}, got {r}")
    rows = 1
    while rows * BOX_ROWS < d:
        rows *= 2
    if rows * r_max > MAX_ROW_VALS:
        raise ValueError(f"gram-apply kernel takes d <= "
                         f"{MAX_ROW_VALS // r_max * BOX_ROWS} at r = {r}, "
                         f"got d = {d}")
    budget = smem_limit - STATIC_SMEM

    def depth(bn):
        return max((s for s in range(2, MAX_STAGES + 1)
                    if smem_bytes(d, bn, s) <= budget), default=0)

    bn = next((b for b in _TILE_COLS if depth(b) >= _MIN_STAGES), None)
    if bn is None:
        bn = next((b for b in _TILE_COLS if depth(b) >= 2), None)
    if bn is None:
        raise ValueError(f"gram-apply: d={d} needs more shared memory than a "
                         f"block has ({smem_limit} bytes)")
    stages = depth(bn)
    per_node = math.ceil(n / bn)
    if nodes <= sm_count:
        items, block_items = _interleaved(
            nodes, per_node, min(sm_count // nodes, per_node))
    else:
        items, block_items = _launch.contiguous_items(
            nodes, per_node, min(sm_count, nodes * per_node))
    items, groups, node_groups, slots = _launch.fold_plan(items, nodes)
    return Plan(r_max, rows, bn, stages, len(block_items) - 1,
                smem_bytes(d, bn, stages), items, tuple(block_items), groups,
                node_groups, slots)


def _interleaved(units: int, per_unit: int, share: int):
    """Each unit's tiles dealt round-robin to ``share`` blocks of its own, so
    that blocks running side by side read neighbouring columns: -> (items
    (unit, first tile, end tile, share), first item of each block)."""
    items = [(u, j, per_unit, share) for u in range(units)
             for j in range(max(1, share))]
    return items, list(range(len(items) + 1))


def packed_smem_bytes(d: int, n: int, r: int, stages: int) -> int:
    """Dynamic shared memory of a packed block (the kernel's
    ``packed_smem_bytes``): the alignment slack, ``stages`` stages of X_i
    and Q_i (d (n + r) floats, 128-byte aligned), the consumer warps' sums
    of z in two slots, a full and an empty mbarrier a stage."""
    stage = -(-4 * d * (n + r) // PACKED_ALIGN) * PACKED_ALIGN
    return (PACKED_ALIGN + stages * stage + 2 * 4 * PACKED_WARPS * n * r
            + 16 * stages)


@dataclasses.dataclass(frozen=True)
class PackedPlan:
    """The route of one launch ("packed" or "tiled") and, for the packed
    route, its work: units of ``vec`` columns, ``lanes`` lanes a row, a
    ring of ``stages`` stages, persistent block g taking the nodes
    ``starts[g]:starts[g + 1]``."""
    route: str
    vec: int = 0
    lanes: int = 0
    stages: int = 0
    grid: int = 0
    smem: int = 0
    starts: Tuple[int, ...] = ()


TILED = PackedPlan("tiled")


@functools.lru_cache(maxsize=256)
def packed_layout(nodes: int, d: int, n: int, r: int, sm_count: int,
                  smem_limit: int):
    """The packed route's plan for these shapes whatever n, or None where
    the packed kernel cannot take them (pure: no card needed).

    X_i and Q_i go by bulk copies, so d n and d r are multiples of 4 floats.
    A thread holds z' (n <= PACKED_MAX_COLS rows) in registers. Units of
    columns are float4s where n % 4 == 0 and r <= 16, else single columns,
    ``lanes`` a row of X in z's product (the units' power of two). The ring
    is the deepest of 2-8 stages of one node that fits, and two must. The
    nodes are cut into one contiguous range a persistent block, at most one
    block an SM.
    """
    if not 1 <= r <= MAX_R:
        raise ValueError(f"gram-apply kernel takes 1 <= r <= {MAX_R}, got {r}")
    if min(nodes, d, n) < 1:
        raise ValueError(f"no packed plan for {nodes} nodes of ({d}, {n})")
    if (d * n) % 4 or (d * r) % 4 or n > PACKED_MAX_COLS:
        return None
    vec = 4 if n % 4 == 0 and r <= 16 else 1
    units = -(-n // vec)
    budget = smem_limit - STATIC_SMEM
    fits = [s for s in range(2, PACKED_MAX_STAGES + 1)
            if packed_smem_bytes(d, n, r, s) <= budget]
    if not fits:
        return None
    grid = min(sm_count, nodes)
    return PackedPlan("packed", vec, 1 << (units - 1).bit_length(), fits[-1],
                      grid, packed_smem_bytes(d, n, r, fits[-1]),
                      tuple(k * nodes // grid for k in range(grid + 1)))


def packed_plan(nodes: int, d: int, n: int, r: int, sm_count: int,
                smem_limit: int) -> PackedPlan:
    """The route of a launch over ``nodes`` nodes of (d, n), r columns of
    Q, on a card with ``sm_count`` SMs and ``smem_limit`` bytes of shared
    memory a block (pure: no card needed): packed where n <= PACKED_MAX_N
    and ``packed_layout`` takes the shapes, else tiled (``plan``)."""
    p = packed_layout(nodes, d, n, r, sm_count, smem_limit)
    return p if p is not None and n <= PACKED_MAX_N else TILED


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/gram_update.cu) with its C signatures set."""
    if not getattr(lib, "_repro_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gram_apply_launch.argtypes = [vp] * 10 + [i] * 12 + [vp]
        lib.gram_apply_launch.restype = ctypes.c_int
        lib.gram_apply_smem_bytes.argtypes = [i, i, i]
        lib.gram_apply_smem_bytes.restype = ctypes.c_size_t
        lib.gram_packed_launch.argtypes = [vp] * 5 + [i] * 9 + [vp]
        lib.gram_packed_launch.restype = ctypes.c_int
        lib.gram_packed_smem_bytes.argtypes = [i] * 4
        lib.gram_packed_smem_bytes.restype = ctypes.c_size_t
        lib._repro_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from . import _build
    return _typed(_build.load("gram_update"))


@functools.lru_cache(maxsize=64)
def _device_plan(device_index: int, nodes: int, d: int, n: int, r: int):
    """The plan for this card, its tables as one int32 tensor on it, and
    the kernel's pointers to them."""
    p = plan(nodes, d, n, r, *_launch.card(device_index))
    table = _launch.plan_table(device_index, p.items, p.block_items,
                               p.groups, p.node_groups)
    return p, table, _launch.table_pointers(
        table, 6 * len(p.items), p.grid + 1, 3 * len(p.groups), nodes + 1)


@functools.lru_cache(maxsize=64)
def _device_packed_plan(device_index: int, nodes: int, d: int, n: int,
                        r: int, route=None):
    """The route for this card (``route`` "packed" or "tiled" overrides the
    planner's choice; "packed" raises where the packed kernel cannot take
    the shapes) and, for the packed route, its ``starts`` as an int32
    tensor on the card and a pointer to it."""
    card = _launch.card(device_index)
    if route is None:
        p = packed_plan(nodes, d, n, r, *card)
    elif route == "packed":
        p = packed_layout(nodes, d, n, r, *card)
        if p is None:
            raise ValueError(f"the packed gram-apply kernel does not take "
                             f"{nodes} nodes of ({d}, {n}), r = {r}")
    elif route == "tiled":
        p = TILED
    else:
        raise ValueError(f"route is 'packed' or 'tiled', got {route!r}")
    if p.route != "packed":
        return p, None, None
    table = _launch.plan_table(device_index, p.starts)
    return p, table, _launch.table_pointers(table, p.grid + 1)[0]


# (device, stream) -> (tickets, partial scratch), see _launch.workspace
_WORK: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def batched_gram_apply_cuda(x_stack: torch.Tensor, q_stack: torch.Tensor,
                            n_true: torch.Tensor, route=None) -> torch.Tensor:
    """x_stack: (N, d, n) f32, q_stack: (N, d, r) f32, n_true: (N,) f32,
    all contiguous on one CUDA device -> (N, d, r) f32.

    Columns of node i past ceil(n_true[i]) are padding and are not used.
    ``route`` ("packed" or "tiled") overrides ``packed_plan``'s choice.
    """
    dev = x_stack.device
    _launch.check(x_stack, "x_stack", (torch.float32,), 3, dev)
    _launch.check(q_stack, "q_stack", (torch.float32,), 3, dev)
    _launch.check(n_true, "n_true", (torch.float32,), 1, dev)
    nodes, d, n = x_stack.shape
    if q_stack.shape[:2] != (nodes, d) or n_true.shape != (nodes,):
        raise ValueError(f"shapes do not align: x {tuple(x_stack.shape)}, "
                         f"q {tuple(q_stack.shape)}, n_true "
                         f"{tuple(n_true.shape)}")
    r = q_stack.shape[2]
    if not 1 <= r <= MAX_R:
        raise ValueError(f"gram-apply kernel takes 1 <= r <= {MAX_R}, got {r}")
    v = torch.empty((nodes, d, r), dtype=torch.float32, device=dev)
    if d == 0 or n == 0 or nodes == 0:
        return v.zero_()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    pk, _, starts = _device_packed_plan(index, nodes, d, n, r, route)
    aligned = x_stack.data_ptr() % 16 == 0 and q_stack.data_ptr() % 16 == 0
    if pk.route == "packed" and (aligned or route == "packed"):
        with _launch.on_device(index):
            err = _lib().gram_packed_launch(
                _launch.ptr(x_stack), _launch.ptr(q_stack),
                _launch.ptr(n_true), _launch.ptr(v), starts, nodes, d, n, r,
                pk.lanes, pk.stages, pk.grid, pk.smem, pk.vec,
                _launch.stream(dev))
        _launch.raise_on_error(err, "gram_packed_launch")
        ROUTE_LAUNCHES["packed"] += 1
        return v
    p, _, tables = _device_plan(index, nodes, d, n, r)
    stream = _launch.stream(dev)
    tickets, partial = _launch.workspace(
        _WORK, index, stream.value, len(p.groups) + nodes, p.slots * d * r)
    how = _staging_route(x_stack)
    with _launch.on_device(index):
        err = _lib().gram_apply_launch(
            _launch.ptr(x_stack), _launch.ptr(q_stack), _launch.ptr(n_true),
            _launch.ptr(partial), _launch.ptr(v), _launch.ptr(tickets),
            *tables, nodes, d, n, r, p.r_max, p.rows, p.bn, p.stages, p.grid,
            p.smem, int(how == "tma"), len(p.groups), stream)
    _launch.raise_on_error(err, "gram_apply_launch")
    ROUTE_LAUNCHES[how] += 1
    return v
