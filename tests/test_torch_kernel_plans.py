"""The launch planners of the gram-apply, slab-apply, Gram and ELL kernels,
and the packed route of the slab / grid kernels, on the CPU.

All are pure functions of the shapes (the ELL kernel's also of the graph's
window, planned from its host-side indices) and of the card's SM count and
shared-memory limit (an H100's 132 SMs and 232,448 bytes here), so their
work lists, and with them the kernels' summation order, can be checked
without a card: every column (or row) falls in exactly one work item, each
unit's partials are summed in one fixed order, and the staging fits shared
memory.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ell_spmm, gram_qr, gram_update, slab_ops

H100 = (132, 232_448)

# (nodes, d, n, r): chip_smoke.py's main path (S-DOT's stack, the explained
# variance over all of X, the 4096-node sparse run) and the card tests'
GRAM_SHAPES = [(20, 1024, 2500, 7), (1, 1024, 2500, 7), (1, 1024, 50_000, 7),
               (4096, 784, 16, 5), (4, 1024, 2500, 7), (64, 784, 14, 5),
               (4, 96, 512, 20), (2, 3000, 3, 2), (3, 40, 37, 64)]
# (blocks, d, n, r): F-DOT's slabs, B-DOT's grid, and the card tests'
APPLY_SHAPES = [(20, 55, 50_000, 7), (20, 256, 10_000, 7), (6, 37, 700, 5),
                (3, 1300, 33, 20), (4, 5, 257, 64), (1, 1, 1, 1),
                (4, 6, 600, 3)]


def _check_items(items, block_items, groups, unit_groups, units, per_unit,
                 slots, grid):
    # blocks take contiguous runs of items, in order, none empty
    assert block_items[0] == 0 and block_items[-1] == len(items)
    assert len(block_items) == grid + 1
    assert all(a < b for a, b in zip(block_items, block_items[1:]))
    # every tile of every unit in exactly one item, items unit-major
    seen = [[0] * per_unit for _ in range(units)]
    for unit, t0, t1, step, _, _ in items:
        assert 0 <= t0 < t1 <= per_unit and step >= 1
        for t in range(t0, t1, step):
            seen[unit][t] += 1
    assert all(c == 1 for row in seen for c in row)
    assert list(items) == sorted(items)
    _check_fold(items, groups, unit_groups, units, slots)


def _check_fold(items, groups, unit_groups, units, slots):
    """Each partial slot written once and read once, in one fixed order: a
    unit's sole item writes the output; else its items' slots are cut into
    groups of consecutive slots, summed in order, and where a unit has
    several groups their sums (consecutive slots) are summed in order."""
    assert len(unit_groups) == units + 1 and unit_groups[-1] == len(groups)
    used = []
    for u in range(units):
        own = [it for it in items if it[0] == u]
        gs = groups[unit_groups[u]:unit_groups[u + 1]]
        if len(own) == 1:
            assert own[0][4:] == (-1, -1) and not gs
            continue
        assert [it[4] for it in own] == list(range(own[0][4],
                                                   own[0][4] + len(own)))
        at = own[0][4]
        for k, (first, count, total) in enumerate(gs):
            assert first == at and count >= 1
            assert all(it[5] == unit_groups[u] + k
                       for it in own if first <= it[4] < first + count)
            at += count
        assert at == own[0][4] + len(own)
        assert max(c for _, c, _ in gs) <= max(
            16, math.isqrt(len(own) - 1) + 1)
        sums = [t for _, _, t in gs]
        if len(gs) == 1:
            assert sums == [-1]
        else:
            assert sums == list(range(sums[0], sums[0] + len(gs)))
            used += sums
        used += [it[4] for it in own]
    assert sorted(used) == list(range(slots))


@pytest.mark.parametrize("shape", GRAM_SHAPES)
def test_gram_plan_covers_every_column_once(shape):
    nodes, d, n, r = shape
    p = gram_update.plan(nodes, d, n, r, *H100)
    per_node = math.ceil(n / p.bn)
    _check_items(p.items, p.block_items, p.groups, p.node_groups, nodes,
                 per_node, p.slots, p.grid)
    # any ceil(n_true) <= n is covered: the tiles span [0, n)
    assert (per_node - 1) * p.bn < n <= per_node * p.bn
    assert 1 <= p.grid <= H100[0]
    assert r <= p.r_max and d <= p.rows * gram_update.BOX_ROWS
    assert p.rows * p.r_max <= gram_update.MAX_ROW_VALS


@pytest.mark.parametrize("shape", GRAM_SHAPES)
def test_gram_plan_fits_shared_memory(shape):
    nodes, d, n, r = shape
    p = gram_update.plan(nodes, d, n, r, *H100)
    assert p.smem == gram_update.smem_bytes(d, p.bn, p.stages)
    assert p.smem + gram_update.STATIC_SMEM <= H100[1]
    assert 2 <= p.stages <= gram_update.MAX_STAGES
    assert p.bn in (8, 16, 32)


def test_gram_plan_is_a_function_of_the_shapes():
    """The order of the sums (items, slots, grid) is the same for equal
    shapes, whenever and however often it is planned; another card (SM
    count) may change it, another n_true cannot (it is no argument)."""
    want = [gram_update.plan(*s, *H100) for s in GRAM_SHAPES]
    gram_update.plan.cache_clear()
    assert [gram_update.plan(*s, *H100) for s in GRAM_SHAPES] == want
    assert gram_update.plan(20, 1024, 2500, 7, 114, H100[1]).grid == 100


def test_gram_plan_main_path_shape():
    """S-DOT's stack: 64-byte row segments, three stages; each node's 157
    tiles dealt round-robin to 6 blocks of its own (120 of the 132 SMs),
    their partials summed in one group."""
    p = gram_update.plan(20, 1024, 2500, 7, *H100)
    assert (p.bn, p.stages, p.grid, p.rows, p.r_max) == (16, 3, 120, 4, 8)
    assert p.items[:6] == tuple((0, j, 157, 6, j, 0) for j in range(6))
    assert p.groups[:2] == ((0, 6, -1), (6, 6, -1)) and p.slots == 120


def test_gram_plan_spreads_one_node_over_every_sm():
    """One node (row 2, and the explained variance over all of X): every
    SM, the 132 partials summed in 11 groups of 12, then the 11 group
    sums."""
    p = gram_update.plan(1, 1024, 2500, 7, *H100)
    assert p.grid == 132 and len(p.groups) == 11
    assert [c for _, c, _ in p.groups] == [12] * 11
    assert p.slots == 132 + 11


def test_gram_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        gram_update.plan(1, 1024, 100, 65, *H100)


# -- the packed route of the gram-apply kernel ---------------------------------
# (nodes, d, n, r): sdot_sparse's stack (4,096 nodes of 784 x 16, and its 14
# samples unpadded: single-column units), the crossover's widest, nodes
# fewer than the SMs, r past 8 and up to 64 at a narrow d, n = 1
GRAM_PACKED_SHAPES = [(4096, 784, 16, 5), (4096, 784, 14, 5),
                      (4096, 1024, 16, 7), (20, 1024, 16, 7),
                      (300, 784, 16, 12), (300, 96, 8, 64), (7, 40, 1, 4),
                      (4096, 784, 24, 5)]


def _gram_packed(shape):
    p = gram_update.packed_plan(*shape, *H100)
    assert p.route == "packed", shape
    return p


@pytest.mark.parametrize("shape", GRAM_PACKED_SHAPES)
def test_gram_packed_plan_covers_every_node_once(shape):
    """Contiguous ranges of nodes in order, one a persistent block, at most
    one an SM, none empty: every node in exactly one."""
    nodes = shape[0]
    p = _gram_packed(shape)
    assert p.grid == min(H100[0], nodes) and len(p.starts) == p.grid + 1
    assert p.starts[0] == 0 and p.starts[-1] == nodes
    sizes = [b - a for a, b in zip(p.starts, p.starts[1:])]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("shape", GRAM_PACKED_SHAPES)
def test_gram_packed_plan_fits_shared_memory(shape):
    """The kernel's formula, a ring of 2-8 stages of one node (X_i and Q_i
    whole), within the H100's 232,448 bytes (227 KB) a block; the units a
    row fit one lane each."""
    _, d, n, r = shape
    p = _gram_packed(shape)
    assert p.smem == gram_update.packed_smem_bytes(d, n, r, p.stages)
    assert p.smem + gram_update.STATIC_SMEM <= H100[1] == 232_448
    assert 2 <= p.stages <= gram_update.PACKED_MAX_STAGES
    assert p.stages * 4 * d * (n + r) < p.smem
    assert p.vec == (4 if n % 4 == 0 and r <= 16 else 1)
    units = -(-n // p.vec)
    assert units <= p.lanes <= 32 and p.lanes & (p.lanes - 1) == 0
    assert p.lanes < 2 * units
    assert (d * n) % 4 == 0 and (d * r) % 4 == 0


def test_gram_packed_plan_main_path_shape():
    """sdot_sparse's stack: float4 units, 4 lanes a row (8 row phases a
    warp), a ring of 3 stages of 65,856 bytes (X_i 50,176, Q_i 15,680), 132
    ranges of 31-32 nodes; the dense stack keeps the stream and its plan."""
    p = _gram_packed((4096, 784, 16, 5))
    assert (p.vec, p.lanes, p.stages, p.grid, p.smem) == (4, 4, 3, 132,
                                                          203_056)
    assert {b - a for a, b in zip(p.starts, p.starts[1:])} == {31, 32}
    assert gram_update.packed_plan(20, 1024, 2500, 7, *H100).route == "tiled"
    test_gram_plan_main_path_shape()


@pytest.mark.parametrize("shape,why", [
    ((20, 1024, 2500, 7), "n past the crossover"),
    ((4096, 784, 30, 5), "n past the crossover, where a ring still fits"),
    ((64, 783, 14, 5), "d n not a multiple of 4"),
    ((64, 785, 16, 5), "d r not a multiple of 4"),
    ((4096, 784, 16, 64), "a stage too big for a ring of two"),
    ((3, 40, 37, 64), "more than 32 columns of z a lane"),
    ((1, 1024, 50_000, 7), "one node, all of X")])
def test_gram_packed_route_refused(shape, why):
    """Where the packed kernel cannot take the shapes, or n is past the
    crossover, the planner keeps the stream."""
    assert gram_update.packed_plan(*shape, *H100) is gram_update.TILED, why


def test_gram_packed_route_follows_n():
    """At d = 784, r = 5, 4,096 nodes: packed up to PACKED_MAX_N wherever a
    ring of two stages fits (up to n = 30: at 31 two stages of X_i and Q_i
    and z's sums take 235,872 bytes), tiled past it."""
    top = gram_update.PACKED_MAX_N
    for n in range(1, 41):
        p = gram_update.packed_plan(4096, 784, n, 5, *H100)
        fits = gram_update.packed_layout(4096, 784, n, 5, *H100) is not None
        assert p.route == ("packed" if n <= top and fits else "tiled"), n
        assert fits == (n <= 30), n


def test_gram_packed_plan_is_a_function_of_the_shapes():
    want = [gram_update.packed_plan(*s, *H100) for s in GRAM_PACKED_SHAPES]
    gram_update.packed_layout.cache_clear()
    assert [gram_update.packed_plan(*s, *H100)
            for s in GRAM_PACKED_SHAPES] == want
    assert gram_update.packed_plan(4096, 784, 16, 5, 114, H100[1]).grid == 114
    with pytest.raises(ValueError):
        gram_update.packed_plan(16, 784, 16, 65, *H100)
    with pytest.raises(ValueError):
        gram_update.packed_plan(0, 784, 16, 5, *H100)
    with pytest.raises(ValueError):
        gram_update.plan(1, 5000, 100, 7, *H100)


@pytest.mark.parametrize("shape", APPLY_SHAPES)
def test_apply_plan_covers_every_column_once(shape):
    blocks, d, n, r = shape
    p = slab_ops.apply_plan(blocks, d, n, r, *H100)
    per_unit = math.ceil(n / p.cols)
    _check_items(p.items, p.block_items, p.groups, p.unit_groups,
                 blocks * p.chunks, per_unit, p.slots, p.grid)
    # the chunks cover the rows, every row owned by one warp
    assert p.chunks * p.rows >= d > (p.chunks - 1) * p.rows
    assert p.rpw * slab_ops.WARPS >= p.rows
    assert p.rpw <= slab_ops.APPLY_VALS // next(m for m in (8, 16, 32, 64)
                                                if r <= m)


@pytest.mark.parametrize("shape", APPLY_SHAPES)
def test_apply_plan_fits_shared_memory(shape):
    blocks, d, n, r = shape
    p = slab_ops.apply_plan(blocks, d, n, r, *H100)
    assert p.smem == slab_ops.apply_smem_bytes(p.rows, p.cols, r, p.stages)
    assert p.smem + slab_ops.STATIC_SMEM <= H100[1]
    assert 2 <= p.stages <= slab_ops.MAX_STAGES
    assert p.cols % 4 == 0 and p.cols <= 256 and p.rows <= 256


def test_apply_plan_is_a_function_of_the_shapes():
    want = [slab_ops.apply_plan(*s, *H100) for s in APPLY_SHAPES]
    slab_ops.apply_plan.cache_clear()
    assert [slab_ops.apply_plan(*s, *H100) for s in APPLY_SHAPES] == want


@pytest.mark.parametrize("d,chunks,rpw,busy", [(55, 1, 7, 8), (256, 4, 8, 8)])
def test_apply_plan_keeps_every_warp_busy(d, chunks, rpw, busy):
    """F-DOT's 55 rows: seven warps of 7 and one of 6; B-DOT's 256: four
    chunks of 64, 8 rows a warp."""
    p = slab_ops.apply_plan(20, d, 10_000, 7, *H100)
    assert (p.chunks, p.rpw) == (chunks, rpw)
    assert sum(1 for w in range(slab_ops.WARPS)
               if min(p.rpw, p.rows - w * p.rpw) > 0) == busy


@pytest.mark.parametrize("counts", [[1], [2, 1], [16], [17], [132, 1, 7],
                                    [5] * 20])
def test_fold_plan_sums_each_unit_in_one_fixed_order(counts):
    """Units with these numbers of items: one level up to 16 partials, two
    levels of about sqrt(items) beyond."""
    from repro_torch.kernels import _launch
    items = [(u, j, j + 1, 1) for u, c in enumerate(counts) for j in range(c)]
    items, groups, unit_groups, slots = _launch.fold_plan(items,
                                                          len(counts))
    _check_fold(items, groups, unit_groups, len(counts), slots)
    assert len(groups) == sum(0 if c == 1 else 1 if c <= 16
                              else math.ceil(c / (math.isqrt(c - 1) + 1))
                              for c in counts)


@pytest.mark.parametrize("n,want", [(2500, "tma"), (16, "tma"), (14, "cp_async"),
                                    (3, "cp_async")])
def test_staging_route_follows_the_row_alignment(n, want):
    x = torch.zeros((2, 8, n))
    s = torch.zeros((2, n, 3))
    assert gram_update.route(x) == want
    assert slab_ops.apply_route(x, s) == want
    # a view that starts 4 bytes in is never 16-byte aligned
    assert gram_update.route(torch.zeros(2 * 8 * n + 1)[1:].view(2, 8, n)) \
        == "cp_async"



# -- the packed route of the slab / grid kernels --------------------------------
# (blocks, J, d, n, r): bdot_sparse's grid (4 x 4,096 blocks of 196 x 16),
# 8 x 8,192 blocks (past the tiled tq kernel's 65,535), ragged ranges (J
# not a multiple of a range's 30-31 blocks), the tiny-blocks case of
# test_torch_slab_kernels.py (n = 14: single columns), d = 1, n = 1, r = 64,
# and a slab stack (J = 1: a Q row a block)
PACKED_SHAPES = [(16_384, 4096, 196, 16, 5), (65_536, 8192, 196, 16, 5),
                 (4 * 1001, 1001, 196, 16, 5), (32, 16, 20, 14, 5),
                 (10, 5, 1, 16, 5), (12, 4, 196, 1, 5),
                 (16_384, 4096, 196, 16, 64), (300, 1, 30, 8, 3)]
# the dense shapes, (blocks, J, d, n, r) for each kernel: F-DOT's slabs
# (tq: J = 1, apply: J = N) and B-DOT's 4 x 5 grid; they keep the tiled
# kernels
DENSE_SHAPES = {"tq": [(20, 1, 55, 50_000, 7), (20, 5, 256, 10_000, 7)],
                "apply": [(20, 20, 55, 50_000, 7), (20, 5, 256, 10_000, 7)]}


def _packed(kernel, shape):
    p = slab_ops.packed_plan(kernel, *shape, *H100)
    assert p.route == "packed", (kernel, shape)
    return p


@pytest.mark.parametrize("shape", PACKED_SHAPES)
@pytest.mark.parametrize("kernel", ["tq", "apply"])
def test_packed_plan_covers_every_block_once(kernel, shape):
    """Contiguous ranges in block order, one a persistent block, at most one
    wave, none empty: every grid block in exactly one; a stage holds at
    most J blocks, so it meets at most two grid rows (tq) or wraps the grid
    columns once at most (apply)."""
    blocks, J = shape[:2]
    p = _packed(kernel, shape)
    assert 1 <= p.grid <= min(H100[0], blocks)
    assert len(p.starts) == p.grid + 1
    assert p.starts[0] == 0 and p.starts[-1] == blocks
    assert all(a < b for a, b in zip(p.starts, p.starts[1:]))
    owner = [g for g in range(p.grid)
             for _ in range(p.starts[g], p.starts[g + 1])]
    assert owner == sorted(owner) and len(owner) == blocks
    assert 1 <= p.blocks_per_stage <= J
    for g in range(p.grid):
        for b0 in range(p.starts[g], p.starts[g + 1], p.blocks_per_stage):
            b1 = min(b0 + p.blocks_per_stage, p.starts[g + 1]) - 1
            assert b1 // J - b0 // J <= 1


@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_packed_tq_stages_q_once_for_each_grid_row_a_range_meets(shape):
    """The kernel's staging, stage by stage with two slots (row % 2): each
    grid row a range meets is staged once, and the rows a stage reads are
    in their slots; ``q_stagings`` counts them."""
    blocks, J = shape[:2]
    p = _packed("tq", shape)
    stagings = 0
    for g in range(p.grid):
        slots, seen = [-1, -1], []
        for b0 in range(p.starts[g], p.starts[g + 1], p.blocks_per_stage):
            b1 = min(b0 + p.blocks_per_stage, p.starts[g + 1])
            rows = range(b0 // J, (b1 - 1) // J + 1)
            for row in rows:
                if slots[row % 2] != row:
                    slots[row % 2] = row
                    seen.append(row)
            assert all(slots[b // J % 2] == b // J for b in range(b0, b1))
        want = list(range(p.starts[g] // J, (p.starts[g + 1] - 1) // J + 1))
        assert seen == want
        stagings += len(seen)
    assert p.q_stagings == stagings
    assert _packed("apply", shape).q_stagings == 0


@pytest.mark.parametrize("shape", PACKED_SHAPES)
@pytest.mark.parametrize("kernel", ["tq", "apply"])
def test_packed_plan_fits_shared_memory(kernel, shape):
    """The kernel's formula, a ring of 2-8 stages, within the H100's
    232,448 bytes; the units a lane fit the kernels' instantiations."""
    _, J, d, n, r = shape
    p = _packed(kernel, shape)
    assert p.smem == slab_ops.packed_smem_bytes(kernel, p.blocks_per_stage,
                                                d, n, r, p.stages)
    assert p.smem + slab_ops.STATIC_SMEM <= H100[1]
    assert 2 <= p.stages <= slab_ops.PACKED_MAX_STAGES
    assert p.vec == (4 if n % 4 == 0 and r <= 16 else 1)
    units = -(-n // p.vec)
    lanes = min(32, 1 << (units - 1).bit_length())
    assert p.unit_lanes & (p.unit_lanes - 1) == 0
    if kernel == "apply":
        assert p.unit_lanes == lanes and p.upl == -(-units // 32)
        assert p.upl <= (2 if p.vec == 4 else 1)
        assert 1 <= p.row_slices <= d
    else:
        assert 1 <= p.unit_lanes <= lanes and p.upl == 1


@pytest.mark.parametrize("kernel", ["tq", "apply"])
def test_packed_route_follows_n(kernel):
    """At d = 196, r = 5 and ~200 MB of X: packed up to the crossover n,
    tiled beyond it, wherever the packed kernel takes the shapes."""
    top = slab_ops.PACKED_MAX_N[kernel]
    for n in (1, 2, 3, 4, 8, 14, 16, 32, 64, 100, 128, 129, 256, 257, 1000):
        blocks = max(4, 50_000_000 // (196 * n) // 4 * 4)
        p = slab_ops.packed_plan(kernel, blocks, blocks // 4, 196, n, 5,
                                 *H100)
        fits = slab_ops.packed_layout(kernel, blocks, blocks // 4, 196, n,
                                      5, *H100) is not None
        assert p.route == ("packed" if n <= top and fits else "tiled"), n
        assert fits or n > 128
    for shape in DENSE_SHAPES[kernel]:
        assert slab_ops.packed_plan(kernel, *shape, *H100).route == "tiled"


def test_packed_plan_main_path_shape():
    """bdot_sparse's grid: float4 units, 8 grid blocks a stage (one a
    warp) in a ring of two, 132 ranges of 124-125 blocks; tq's warps take a
    block's four units over eight row phases, two grid rows staged by the
    ranges that cross one."""
    shape = (16_384, 4096, 196, 16, 5)
    tq, ap = _packed("tq", shape), _packed("apply", shape)
    for p in (tq, ap):
        assert (p.vec, p.upl, p.unit_lanes, p.blocks_per_stage, p.stages,
                p.grid) == (4, 1, 4, 8, 2, 132)
        assert {b - a for a, b in zip(p.starts, p.starts[1:])} == {124, 125}
    assert ap.row_slices == 1
    assert tq.q_stagings == 132
    assert all(s % 4096 == 0 for s in tq.starts[::33])
    assert tq.smem == 213_392 and ap.smem == 205_968


def test_packed_plan_is_a_function_of_the_shapes():
    want = [slab_ops.packed_plan(k, *s, *H100)
            for k in ("tq", "apply") for s in PACKED_SHAPES]
    slab_ops.packed_layout.cache_clear()
    assert [slab_ops.packed_plan(k, *s, *H100)
            for k in ("tq", "apply") for s in PACKED_SHAPES] == want
    # another card may cut other ranges
    assert slab_ops.packed_plan("tq", *PACKED_SHAPES[0], 114,
                                H100[1]).grid == 114


def test_packed_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        slab_ops.packed_plan("tq", 16, 4, 196, 16, 65, *H100)
    with pytest.raises(ValueError):
        slab_ops.packed_plan("apply", 10, 4, 196, 16, 5, *H100)  # 4 !| 10
    with pytest.raises(ValueError):
        slab_ops.packed_plan("gram", 16, 4, 196, 16, 5, *H100)
    # a block too big for a ring of two stages, or S too wide for a lane's
    # registers: no packed layout, and the planner keeps the tiled kernels
    assert slab_ops.packed_layout("apply", 8, 4, 196, 256, 5, *H100) is None
    assert slab_ops.packed_layout("apply", 8, 4, 20, 33, 5, *H100) is None


# -- the CholeskyQR Gram kernel ------------------------------------------------
QR_D = [1, 3, 55, 1023, 1025, 16384]
QR_R = [1, 7, 8, 9, 64, 128]


def _qr_rows(p, batch, d):
    """Each matrix's rows as the plan's blocks take them, per tile pair:
    block k takes work item k, ranges of a unit in order."""
    seen = {}
    for unit, c, end, step, _, _ in p.items:
        assert (end, step) == (c + 1, 1)
    for block in range(p.blocks):
        unit, rows = p.block_rows(block, d)
        assert unit == p.items[block][0]
        seen.setdefault(unit, []).append(rows)
    assert sorted(seen) == list(range(batch * p.pairs))
    return seen


def _check_cluster(p, batch, d, esize):
    """A cluster route plan: each part of each tile pair takes every row of
    its matrix in exactly one of its ranges, in order, whole groups of 8
    rows (so 16-byte aligned), none empty where d >= 8 ranges; clusters of
    at most 16 blocks dividing the ranges and the blocks, all of them at
    once on the card where the tile pairs fit it; partials (one fold level)
    only where a part has more than one row cluster; the staging buffers,
    the threads' sums and the slices' copies within 227 KB."""
    units = batch * p.pairs
    assert p.cluster in (2, 4, 8, 16) and p.ranges == p.cluster * p.clusters
    assert p.blocks == units * p.parts * p.ranges
    assert p.blocks % p.cluster == 0 and 1 <= p.parts <= 36
    if units <= H100[0] // p.cluster - gram_qr.CLUSTER_SPARE:
        assert p.blocks // p.cluster <= H100[0] // p.cluster - 1
    for u in range(units):
        for part in range(p.parts):
            first = (u * p.parts + part) * p.ranges
            rows = [p.block_rows(first + c, d) for c in range(p.ranges)]
            assert {unit for unit, _ in rows} == {u}
            assert [k for _, rg in rows for k in rg] == list(range(d))
            assert all(rg.start * p.stride * esize % 16 == 0
                       and len(rg) <= p.rows_per_range for _, rg in rows)
            if d >= 8 * p.ranges:
                assert all(len(rg) > 0 for _, rg in rows)
    assert p.groups == () and p.slots == (
        units * p.parts * p.clusters if p.clusters > 1 else 0)
    assert p.tickets == units * p.parts * p.cluster
    assert p.recv_offset % 16 == 0 and p.smem == p.recv_offset + 4 * p.tile ** 2
    assert 2 * p.buf_elems * esize <= p.recv_offset and p.smem <= H100[1]
    assert p.rows_per_range % 8 == 0 and p.chunk_rows % 16 == 0


@pytest.mark.parametrize("is_bf16", [False, True])
@pytest.mark.parametrize("r", QR_R)
@pytest.mark.parametrize("d", QR_D)
def test_gram_qr_plan_covers_every_row_once(d, r, is_bf16):
    """Every row of every matrix falls in exactly one range of each tile
    pair; ranges start a whole number of 16-byte units into their matrix
    and none is empty; the blocks fit one wave (one an SM) unless the
    batch alone exceeds it; the staging buffers and the phase sums fit
    shared memory. A plan on the cluster route is held to the same by
    ``_check_cluster``, for each part of each tile pair."""
    batch = 3
    p = gram_qr.plan(batch, d, r, is_bf16, H100[0])
    esize = 2 if is_bf16 else 4
    if p.route == "cluster":
        _check_cluster(p, batch, d, esize)
        return
    for unit, ranges in _qr_rows(p, batch, d).items():
        rows = [k for rg in ranges for k in rg]
        assert rows == list(range(d)), unit
        assert all(rg.start * r * esize % 16 == 0 for rg in ranges)
        assert all(len(rg) > 0 for rg in ranges)
    assert p.blocks == batch * p.pairs * p.ranges
    assert p.blocks <= H100[0] or p.ranges == 1
    assert p.rows_per_range % 8 == 0 and p.chunk_rows % 16 == 0
    assert p.smem <= H100[1] and p.buf_elems * esize % 16 == 0
    _check_fold(p.items, p.groups, p.unit_groups, batch * p.pairs, p.slots)


@pytest.mark.parametrize("r,is_bf16,how,want", [
    (7, False, "simt", ("simt", 8)), (7, True, "simt", ("simt", 8)),
    (16, True, "simt", ("cluster", 16)), (24, True, "tc_bf16", ("tc_bf16", 64)),
    (33, True, "simt", ("cluster", 64)), (64, True, "tc_bf16", ("tc_bf16", 64)),
    (128, True, "tc_bf16", ("tc_bf16", 64)),
    (128, False, "simt", ("cluster", 64))])
def test_gram_qr_route_follows_type_and_width(r, is_bf16, how, want):
    """bf16 goes to the tensor cores where r is a multiple of 8 above 16;
    f32 never does (TF32 would move the Gram). The CUDA cores' shapes above
    r = 8 of two matrices (6 tile pairs at r = 128) take the cluster
    route; r <= 8 reads rows straight into registers."""
    p = gram_qr.plan(2, 1000, r, is_bf16, H100[0])
    assert (p.route, p.tile) == want
    assert gram_qr.route(r, is_bf16) == how


def test_gram_qr_plan_main_path_shapes():
    """S-DOT's (20, 1024, 7), B-DOT's (4, 256, 7) and F-DOT's (20, 55, 7):
    one block a matrix, whose threads read 4 rows or fewer each straight
    into registers, no partials; (1, 16384, 7): 4 ranges of 4096 rows, one
    group; the tall (16384, 128): 3 tile pairs of 44 ranges (132 blocks,
    one an SM), folded a tile pair in 7 groups of at most 7 and then the
    groups' sums, in bf16 (the tensor cores); in f32 the cluster route,
    each tile pair's rows in 2 row clusters of 16 ranges of 512 rows."""
    p = gram_qr.plan(20, 1024, 7, False, H100[0])
    assert (p.ranges, p.rows_per_range, p.blocks, p.slots) == (
        1, 1024, 20, 0)
    assert p.groups == () and len(p.items) == 20 and p.buf_elems == 0
    assert (gram_qr.plan(4, 256, 7, False, H100[0]).blocks,
            gram_qr.plan(20, 55, 7, False, H100[0]).blocks) == (4, 20)
    p = gram_qr.plan(1, 16384, 7, False, H100[0])
    assert (p.ranges, p.rows_per_range, p.groups) == (4, 4096, ((0, 4, -1),))
    p = gram_qr.plan(1, 16384, 128, True, H100[0])
    assert (p.pairs, p.ranges, p.blocks) == (3, 44, 132)
    assert [c for _, c, _ in p.groups] == ([7] * 6 + [2]) * 3
    assert p.unit_groups == (0, 7, 14, 21) and p.slots == 153
    p = gram_qr.plan(1, 16384, 128, False, H100[0])
    assert (p.route, p.pairs, p.parts, p.clusters, p.ranges, p.blocks) == (
        "cluster", 3, 1, 2, 32, 96)
    assert p.rows_per_range == 512 and p.slots == 6


# the PSA trainer's refresh Grams (B, d, r = 64): train_psa's qwen2-7b
# (d_model, d_ff two a launch, the head alone), train_psa_moe's phi3.5-moe
# (the expert stacks' d_model and d_expert, the head)
QR_REFRESH = [(2, 3584), (2, 18944), (1, 3584), (1, 4096), (1, 6400),
              (1, 4096)]


@pytest.mark.parametrize("batch,d", QR_REFRESH)
def test_gram_qr_plan_takes_cluster_at_refresh_shapes(batch, d):
    """The refresh's f32 Grams take the cluster route: its clusters fit
    the card at once, and the rows of a part are split over row clusters
    (one fold level) only where a block would take more than
    CLUSTER_MAX_ROWS."""
    p = gram_qr.plan(batch, d, 64, False, H100[0])
    assert p.route == "cluster" and p.tile == 64 and p.pairs == 1
    assert p.blocks // p.cluster <= H100[0] // p.cluster - 1
    assert (p.clusters > 1) == (
        d > p.cluster * gram_qr.CLUSTER_MAX_ROWS)
    _check_cluster(p, batch, d, 4)


# the main path's r = 7 Grams: S-DOT's nodes, F-DOT's slabs, B-DOT's row
# slabs, sdot_spmd's one node a rank -> (rows a range, chunk rows)
QR_MAIN = {(20, 1024): (1024, 1024), (20, 55): (56, 64), (4, 256): (256, 256),
           (1, 1024): (1024, 1024)}


@pytest.mark.parametrize("batch,d", sorted(QR_MAIN))
def test_gram_qr_plan_main_path_r7_unchanged(batch, d):
    """The main path's r = 7 plans, field by field, as before the cluster
    route: one block a matrix reading its rows straight into registers,
    no partials, no cluster."""
    rows, chunk = QR_MAIN[(batch, d)]
    p = gram_qr.plan(batch, d, 7, False, H100[0])
    assert dataclasses.asdict(p) == {
        "route": "simt", "tile": 8, "vec": False, "pairs": 1, "ranges": 1,
        "rows_per_range": rows, "chunk_rows": chunk, "stride": 7,
        "buf_elems": 0, "smem": 2304,
        "items": tuple((u, 0, 1, 1, -1, -1) for u in range(batch)),
        "groups": (), "unit_groups": (0,) * (batch + 1), "slots": 0,
        "cluster": 1, "clusters": 1, "parts": 1, "recv_offset": 0}
    assert p.tickets == batch


@pytest.mark.parametrize("batch,d,r", [(1, 55, 64), (1, 700, 16),
                                       (2, 257, 33), (3, 16384, 128),
                                       (20, 1024, 64), (1, 4096, 9)])
def test_gram_qr_cluster_plan_forced_covers_every_row_once(batch, d, r):
    """The cluster route forced (the crossover's timings), where the plan
    would not take it too: the same invariants."""
    p = gram_qr.plan(batch, d, r, False, H100[0], "cluster")
    assert p.route == "cluster"
    _check_cluster(p, batch, d, 4)


def test_gram_qr_plan_refuses_what_the_routes_do_not_take():
    """An empty shape; the cluster route at r <= 8 (the direct route's) or
    on the tensor cores' bf16 shapes; a route of another type."""
    for shape in ((0, 1024, 64), (1, 0, 64), (1, 1024, 0)):
        with pytest.raises(ValueError):
            gram_qr.plan(*shape, False, H100[0])
        with pytest.raises(ValueError):
            gram_qr.plan(*shape, False, H100[0], "cluster")
    for r, is_bf16, force in ((7, False, "cluster"), (64, True, "cluster"),
                              (64, False, "tc_bf16"), (64, True, "simt")):
        with pytest.raises(ValueError):
            gram_qr.plan(1, 4096, r, is_bf16, H100[0], force)


def test_gram_qr_plan_is_a_function_of_the_shapes():
    shapes = [(b, d, r, f) for b in (1, 20) for d in QR_D for r in QR_R
              for f in (False, True)]
    want = [gram_qr.plan(*s, H100[0]) for s in shapes]
    gram_qr.plan.cache_clear()
    assert [gram_qr.plan(*s, H100[0]) for s in shapes] == want
    with pytest.raises(ValueError):
        gram_qr.plan(1, 0, 7, False, H100[0])


# -- the ELL gossip kernel ----------------------------------------------------
def _sparse(kind, n):
    from repro_torch.core import topology
    from repro_torch.core.sparse import SparseW
    g = (topology.watts_strogatz(n, k=6, p=0.1, seed=1) if kind == "ws"
         else topology.erdos_renyi(n, 6 / n, seed=1, ensure_connected=False))
    return SparseW.from_graph(g, device="cpu")


@pytest.mark.parametrize("n,k,width,window,vec", [
    (4096, 3920, 9, (32, 2), True), (4096, 3920, 16, (32, 0), True),
    (300, 35, 5, (64, 8), False), (1, 1, 1, (64, 16), False),
    (130, 257, 40, (16, 4), False), (64, 512, 3, (32, 0), True),
    (5000, 8, 700, (8, 2), True)])
def test_ell_plan_covers_every_element_once(n, k, width, window, vec):
    """Every (row, column) in exactly one block; the window is the band
    and ``halo`` rows either side, clipped at row 0 and row N - 1."""
    band, halo = window
    p = ell_spmm.plan(n, k, width, window, vec)
    assert (p.band_rows, p.halo) == window
    hits = np.zeros((n, k), np.int32)
    for b in range(p.blocks):
        rows, cols, win = p.block(b, n, k)
        assert len(rows) > 0 and len(cols) > 0
        hits[rows.start:rows.stop, cols.start:cols.stop] += 1
        assert win.start == max(0, rows.start - halo)
        assert win.stop == min(n, rows.stop + halo)
        assert len(win) <= band + 2 * halo
    assert (hits == 1).all()
    assert p.tile_cols <= ell_spmm.TILE_COLS
    assert not vec or p.tile_cols % 4 == 0
    assert p.smem <= 232_448


@pytest.mark.parametrize("batch,n,k,width,window,vec", [
    (4, 4096, 980, 9, (32, 2), True), (3, 300, 35, 5, (64, 8), False),
    (2, 130, 257, 40, (16, 4), False), (1, 64, 512, 3, (32, 0), True),
    (5, 33, 1, 2, (8, 16), False)])
def test_ell_batched_plan_covers_every_member_element_once(batch, n, k, width,
                                                           window, vec):
    """A batch of B matrices: every (member, row, column) in exactly one
    block, each member cut as a launch of it alone would cut it, within the
    kernel's 200 KB of shared memory."""
    p = ell_spmm.plan(n, k, width, window, vec, batch)
    one = ell_spmm.plan(n, k, width, window, vec)
    assert p.blocks == batch * one.blocks and p.smem == one.smem
    hits = np.zeros((batch, n, k), np.int32)
    for b in range(p.blocks):
        m = p.member(b)
        rows, cols, win = p.block(b, n, k)
        assert (rows, cols, win) == one.block(b % one.blocks, n, k)
        hits[m, rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (hits == 1).all()
    assert p.smem <= ell_spmm.SMEM_LIMIT == 200 * 1024
    with pytest.raises(ValueError):
        ell_spmm.plan(n, k, width, window, vec, 0)


def test_ell_plan_main_path_shape():
    """watts_strogatz(4096, 6, 0.1) at K = 3920: 128 bands of 32 rows by 16
    tiles of 248 columns; ~38 KB of shared memory, so four blocks an SM."""
    p = ell_spmm.plan(4096, 3920, 9, (32, 2), True)
    assert (p.band_rows, p.tile_cols, p.bands, p.tiles) == (32, 248, 128, 16)
    assert p.smem <= ell_spmm.SMEM_BUDGET


@pytest.mark.parametrize("kind", ["ws", "er"])
def test_ell_window_plan_from_host_indices(kind, monkeypatch):
    """The staging comes from the host-side indices alone (no torch CUDA
    call), once per SparseW: watts_strogatz(4096, 6, 0.1) gets a halo of 2
    (92.6% of slots in the window), a graph without locality none (its
    window is the band, which still serves the padded slots); the counts
    are the indices' own."""
    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call while planning the window")
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    monkeypatch.setattr(torch.cuda, "current_device", no_cuda)
    sw = _sparse(kind, 4096)
    wp = sw.window
    idx = sw.ell_idx.numpy()
    assert wp == ell_spmm.window_plan(idx)
    assert (wp.band_rows, wp.halo) == ((32, 2) if kind == "ws" else (32, 0))
    n = idx.shape[0]
    rows = np.arange(n)[:, None] // wp.band_rows * wp.band_rows
    inside = ((idx >= np.maximum(rows - wp.halo, 0))
              & (idx < np.minimum(rows + wp.band_rows + wp.halo, n)))
    assert wp.in_window == int(inside.sum()) and wp.slots == idx.size
    assert wp.gathers == idx.size - wp.in_window
    # padded slots point at their own row: always in the window
    pads = sw.ell_width * n - int(sw.row_nnz.sum())
    assert wp.in_window >= pads
    if kind == "ws":
        assert wp.in_window_share > 0.9
    assert sw.astype(torch.float64).window is wp


def test_ell_window_plan_weighs_staged_rows_against_gathers():
    """A ring lattice's neighbours lie 1-3 rows away: a halo of 2 or more
    serves nearly every slot from the window. A star's hub has N - 1 slots:
    no band's slots fit the budget beside a window, so the window is staged
    alone (the slots read from device memory), and a halo buys nothing."""
    n = 1024
    rows = np.arange(n)[:, None]
    lattice = (rows + np.array([-3, -2, -1, 1, 2, 3])) % n
    wp = ell_spmm.window_plan(lattice.astype(np.int32))
    assert wp.halo >= 2 and wp.in_window_share > 0.98
    assert ell_spmm.plan(n, 3920, 6, (wp.band_rows, wp.halo), True).staged
    star = _star(n)
    wp = ell_spmm.window_plan(star)
    assert wp.halo == 0
    for k in (3920, 35):
        p = ell_spmm.plan(n, k, n - 1, (wp.band_rows, wp.halo), k % 4 == 0)
        assert not p.staged
        assert p.smem == 4 * wp.band_rows * p.tile_cols <= \
            ell_spmm.SMEM_BUDGET


def _star(n):
    star = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, n - 1))
    star[0] = np.arange(1, n)
    star[1:, 0] = 0
    return star


@pytest.mark.parametrize("width", [1, 9, 100, 613, 614, 1023, 3075, 3076,
                                   4095, 16383])
def test_ell_plan_fits_the_kernel_at_every_width(width):
    """At any width and any window of BANDS x HALOS the launch's shared
    memory stays within the kernel's 200 KB: the band's slots are staged
    where they fit the budget beside the window, else read from device
    memory; what the kernel is told matches what it stages."""
    for band in ell_spmm.BANDS:
        for halo in ell_spmm.HALOS:
            for k, vec in ((3920, True), (35, False), (1, False)):
                p = ell_spmm.plan(4096, k, width, (band, halo), vec)
                window = 4 * (band + 2 * halo) * p.tile_cols
                slots = 4 * band * (2 * width + 1)
                assert p.staged == (window + slots <= ell_spmm.SMEM_BUDGET)
                assert p.smem == window + (slots if p.staged else 0)
                assert p.smem <= ell_spmm.SMEM_LIMIT == 200 * 1024


# ---------------------------------------------------------------------------
# lane folds: how many sweep lanes of r columns one launch takes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lanes,r,want", [
    (12, 7, 9),     # 63 of the kernel's 64 columns
    (4, 7, 4),      # fdot_dense's sweep: every lane in one launch
    (3, 7, 3),      # fewer lanes than it takes
    (12, 3, 12),
    (30, 3, 21),
    (5, 64, 1),     # one lane fills the kernel
    (12, 16, 4),
])
def test_lane_fold_width(lanes, r, want):
    """The widest lane fold of the slab tq kernel: as many lanes as it
    takes columns, and one lane more would pass the kernel's limit where
    the lanes allow it."""
    from repro_torch.kernels import ops
    g = ops.lane_fold_width(lanes, r)
    assert g == want and g * r <= slab_ops.MAX_R
    if g < lanes:
        assert (g + 1) * r > slab_ops.MAX_R


@pytest.mark.parametrize("r", [0, 65])
def test_lane_fold_width_refuses_what_the_kernel_does_not_take(r):
    from repro_torch.kernels import ops
    with pytest.raises(ValueError, match="slab-tq kernel takes"):
        ops.lane_fold_width(4, r)
