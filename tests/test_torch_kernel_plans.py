"""The launch planners of the gram-apply and slab-apply kernels, on the CPU.

Both are pure functions of the shapes and of the card's SM count and
shared-memory limit (an H100's 132 SMs and 232,448 bytes here), so their
work lists, and with them the kernels' summation order, can be checked
without a card: every column falls in exactly one work item, each unit's
partials are summed in one fixed order, and the ring fits shared memory.
"""
import math

import pytest
import torch

from repro_torch.kernels import gram_update, slab_ops

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
