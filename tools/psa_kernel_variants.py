"""Time text variants of the gram-apply, slab-apply, Gram and ELL kernels
beside the kernels themselves, on the card, in one process.

    python3 tools/psa_kernel_variants.py [--variant NAME ...] [--rounds 2]

Each variant is a source of ``csrc/`` (``gram_update``, ``slab_ops``,
``gram_qr``, ``ell_spmm``) with a few lines replaced, in the source or in
``hopper.cuh`` (see ``VARIANTS``): a piece of the work taken out, to see
what that piece costs, or a parameter changed; or the wrapper's module with
a constant replaced (``PLAN``, e.g. the tile widths the planner may pick,
or the bytes a Gram range holds at least); or the kernel itself on S-DOT's
stack zero-padded to a longer row (``STRIDE``: the same work at another row
stride); or the ELL kernel with another window (band, halo) than the
graph's own (``HALO``). A variant whose lines are not in the
sources any more is skipped with a note. Each variant's sources go to its
own directory under ``build/psa_variants/`` and are built there by nvcc in
parallel, with the flags of ``kernels/_build.py``. Each runs through the
port's own wrapper (``ops.batched_gram_apply`` and ``ops.gram_apply``, the
former also at sdot_sparse's stack on the packed route, or
``ops.batched_slab_apply`` and ``ops.grid_block_apply``, ``ops.gram_qr`` at
chip_smoke.py's five Gram shapes, ``ops.ell_spmm`` over a (4096, 3920)
payload on watts_strogatz(4096, 6, 0.1) in f32 and bf16 and on
erdos_renyi(4096, 0.0015) in f32) at chip_smoke.py's main-path shapes, in
turns, for ``--rounds`` rounds: device time a launch as chip_smoke.py takes
it (CUDA events around 20 launches behind a spin of the card, median of
5), and the largest error relative to the plain version's max |V| (a
variant that leaves work out is wrong on purpose). Prints one
JSON line a variant, shape and round, then a summary with the card's name
and power limit.

    python3 tools/psa_kernel_variants.py --lane-fold [--rounds 2]

times a sweep's lanes instead: for the gram-apply kernel over 12 lanes at
S-DOT's shape and the slab tq and apply kernels over 4 at F-DOT's (r = 7),
the widest fold of the lanes into the kernel's columns that its planner
admits, against one launch a lane (``ops.lane_gram_apply``,
``lane_slab_tq``, ``lane_slab_apply``), each against the plain version.

    python3 tools/psa_kernel_variants.py --packed-plans [--rounds 2]

times the grid kernels' packed route at bdot_sparse's grid (16,384 blocks
of 196 x 16, r = 5) under other plans than ``slab_ops.packed_plan``'s:
each of ``PACKED_PLANS`` (grid blocks a stage, ring stages, row slices,
lanes a unit group) in place of the planner's, in turns (forward, then
backward), each against the plain version; a plan whose ring does not fit
shared memory is skipped.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the last blocks' ordered sums of the partials (the tickets still count)
_FOLD = ("  __syncthreads();\n  if (!*flag) return;\n  __threadfence();\n"
         "  const bool sole")
_HALVES = ("        hopper::halve<32>(p, lane, 16);\n"
           "        hopper::halve<16>(p, lane, 8);\n"
           "        hopper::halve<8>(p, lane, 4);\n"
           "        hopper::halve<4>(p, lane, 2);\n"
           "        hopper::halve<2>(p, lane, 1);\n")
_VUPDATE = "              vacc[m][j] = fmaf(xv[m][c], zc[j], vacc[m][j]);\n"
_PARTIAL = "            p[c * RMAX + j] = t;\n"
_PROMO = "CU_TENSOR_MAP_L2_PROMOTION_L2_256B"
_STREAM = [(_HALVES, ""), (_VUPDATE, "              {}\n"),
           (_PARTIAL, "            p[c * RMAX + j] = xv[0][c];\n")]
_SLAB_STREAM = [("    for (int c4 = 4 * lane; c4 < cols; c4 += 128) {",
                 "    for (int c4 = 4 * lane; c4 < 0; c4 += 128) {")]
_PACKED_Z = ("      for (int k = k_lo + p; k < k_hi; k += P) {",
             "      for (int k = k_lo + p; k < 0; k += P) {")
_PACKED_V = ("      for (int k = gtid; k < d; k += kGroupWarps * 32) {",
             "      for (int k = gtid; k < 0; k += kGroupWarps * 32) {")
_PACKED_GROUPS = "constexpr int kPackedGroups = 2;"
_PACKED_WARPS = "constexpr int kPackedWarps = 8;"
_PACKED_NO_LOAD = (
    "        hopper::mbar_expect_tx(bar, x_bytes + q_bytes);\n"
    "        hopper::bulk_load(dst, a.x + node * d * n, x_bytes, bar);\n"
    "        hopper::bulk_load(dst + x_bytes, a.q + node * d * r, q_bytes, "
    "bar);\n", "        hopper::mbar_arrive(bar);\n")
# source -> variant -> [(text, replacement)]
VARIANTS = {
    "gram_update": {
        "kernel": [],
        # the node's last block does not sum the partials
        "no_fold": [(_FOLD, _FOLD.replace("return;", "return;\n  return;"))],
        # no shuffles: each warp's own partials stand in for the sums
        "no_reduce": [(_HALVES, "")],
        # no V += x z
        "no_vupdate": [(_VUPDATE, "              {}\n")],
        # no z partials: each lane's first x stands in
        "no_partials": [(_PARTIAL, "            p[c * RMAX + j] = xv[0][c];\n")],
        # only the ring, the reductions' barriers and the fold
        "stream_only": _STREAM,
        # the tensor map's L2 promotion: none, or 128 bytes
        "promo_none": [(_PROMO, "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
        "promo_128": [(_PROMO, "CU_TENSOR_MAP_L2_PROMOTION_L2_128B")],
        "stream_promo_none": _STREAM + [(_PROMO,
                                         "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
        # 32-byte row segments (the planner's narrowest tile), deeper ring
        "bn8": [],
        "stream_bn8": _STREAM,
        # X staged by the 4-byte cp.async route, as for n % 4 != 0
        "stream_cp_async": _STREAM + [(
            "node_groups, d, n, r, bn, stages, box_rows, tma,",
            "node_groups, d, n, r, bn, stages, box_rows, 0,")],
        # the packed route without its z product's rows, without its V
        # product's rows, and with neither (the ring, barriers and sums)
        "packed_no_z": [_PACKED_Z],
        "packed_no_v": [_PACKED_V],
        "packed_ring_only": [_PACKED_Z, _PACKED_V],
        # no loads: each stage's mbarrier completed by a plain arrival (the
        # compute alone, on whatever the ring holds)
        "packed_compute_only": [_PACKED_NO_LOAD],
        # the consumer warps as one group on one node at a time; two groups
        # of 6 or 8 warps (the wrapper's PACKED_WARPS with them, ``PLAN``)
        "packed_groups1": [(_PACKED_GROUPS, "constexpr int kPackedGroups = 1;")],
        "packed_w12": [(_PACKED_WARPS, "constexpr int kPackedWarps = 12;")],
        "packed_w16": [(_PACKED_WARPS, "constexpr int kPackedWarps = 16;")],
        "packed_w12_compute_only": [
            (_PACKED_WARPS, "constexpr int kPackedWarps = 12;"),
            _PACKED_NO_LOAD],
    },
    "slab_ops": {
        "kernel": [],
        "no_fold": [(_FOLD, _FOLD.replace("return;", "return;\n  return;"))],
        # only the ring: no column loop
        "stream_only": _SLAB_STREAM,
        "promo_none": [(_PROMO, "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
        "stream_promo_none": _SLAB_STREAM + [
            (_PROMO, "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
        # narrower tiles, deeper ring
        "c128": [],
        "c64": [],
        "stream_c128": _SLAB_STREAM,
    },
}
_QR_FOLD = "  hopper::fold_partials(a.items"
# MIN_RANGE_BYTES of the Gram plans timed beside the planner's
_QR_RANGES = (1024, 8192, 16384, 32768, 65536, 131072, 1 << 40)
_QR_CLUSTER_PLANS = {
    "cluster8": {"CLUSTER": 8}, "cluster4": {"CLUSTER": 4},
    **{f"cmin{n}": {"CLUSTER_MIN_ROWS": n} for n in (8, 32, 64, 128)},
    **{f"cmax{n}": {"CLUSTER_MAX_ROWS": n} for n in (64, 128, 256, 1024,
                                                      1 << 20)},
    **{f"cparts{n}": {"CLUSTER_MAX_PARTS": n} for n in (1, 2, 4)},
    **{f"cspare{n}": {"CLUSTER_SPARE": n} for n in (0, -3, -6)},
    "staged": {"CLUSTER_MAX_UNITS": 0}}
_QR_STAGE = ("    hopper::cp_async_16(hopper::smem_u32(buf + u * U), v + at,\n"
             "                        left >= (size_t)U ? 16 : (int)(left * "
             "sizeof(In)));\n")
VARIANTS["gram_qr"] = {
    "kernel": [],
    # the plan with other range sizes (PLAN)
    **{f"range{b}": [] for b in _QR_RANGES},
    # the ranges' partials are written but not folded
    "no_fold": [(_QR_FOLD, "  return;\n" + _QR_FOLD)],
    # nothing staged or summed: the launch, the partials' writes and the
    # fold alone (of zero tiles)
    "fold_only": [("    const int chunks = k_end > k_begin\n",
                   "    const int chunks = k_end < 0\n")],
    # the flat copy as plain 16-byte loads (the tail unit left out)
    "plain_stage": [(_QR_STAGE, "    if (left >= (size_t)U)\n"
                     "      *reinterpret_cast<uint4*>(buf + u * U) =\n"
                     "          __ldcg(reinterpret_cast<const uint4*>(v + at));\n")],
    # no sums (the staged rows are not read; above r = 8)
    "no_compute": [("      route.rows(buf0 + (c & 1) * a.buf_elems + off, "
                    "a.stride, k1 - k0);\n", "      {}\n")],
    # the plan's constants of the cluster route (PLAN): clusters of 8 (the
    # portable size) or 4, a block's least rows, and no cluster route (the
    # staged ranges and their two-level fold, the parent's launch)
    **{v: [] for v in _QR_CLUSTER_PLANS},
    # the cluster route's pieces: each thread's own phase in place of the
    # phases' sum, the slices' copies kept in the block's own shared memory
    # (no distributed shared memory), no partials' ticket or fold across
    # row clusters
    "cl_no_phase_sum": [("        route.phase_sum(red, w);", "        red[w];")],
    "cl_no_push": [("    cluster.map_shared_rank(recv, owner)[rank * n + w - "
                    "owner * n] =", "    recv[rank * n + w - owner * n] =")],
    "cl_no_fold": [("  __threadfence();\n  __syncthreads();\n  int* ticket",
                    "  return;\n  __threadfence();\n"
                    "  __syncthreads();\n  int* ticket")],
    # a tile pair's only range writes nothing
    "no_write": [("    write_gram<T>(tile, gb, a.r, ti, tj);\n    return;\n  }\n"
                  "  const int slot",
                  "    return;\n  }\n  const int slot")],
    # no barrier after a chunk's sums
    "no_chunk_sync": [("      __syncthreads();               // the buffer "
                       "is free for chunk c + 2\n", "")]}
VARIANTS["ell_spmm"] = {
    "kernel": [],
    # another staging (HALO)
    **{v: [] for v in ("b64h2", "b32h0", "b32h8", "b16h2", "b8h0")},
    # at most 64 registers a thread: four blocks an SM
    "regs64": [("__launch_bounds__(kThreads)\nell_spmm_kernel",
                "__launch_bounds__(kThreads, 4)\nell_spmm_kernel")],
    # four messages loaded before their FMAs
    "slots4": [("constexpr int kSlots = 2;", "constexpr int kSlots = 4;")],
    # no slots summed (the own term alone)
    "no_slots": [("    int l = 0;\n", "    int l = a.width;\n")],
    # nothing stored (a condition the compiler cannot prove false)
    "no_store": [("    float* o = a.out + (size_t)row * a.k + c0;\n",
                  "    if (a.k > 0) continue;\n"
                  "    float* o = a.out + (size_t)row * a.k + c0;\n")],
    # nothing is copied (the sums read whatever shared memory holds)
    "no_stage": [("        hopper::cp_async_16(hopper::smem_u32(d), src, 16);\n",
                  "        {}\n")]}
# the PSA trainer's refresh Grams (chip_smoke.py's train_psa and
# train_psa_moe rows), and one range of 32 rows: a launch that writes no
# partial, the floor of a one-block Gram at r = 64 (f32)
QR_REFRESH_SHAPES = (
    ("psa_a3584", (1, 3584, 64)), ("psa_a4096", (1, 4096, 64)),
    ("psa_a6400", (1, 6400, 64)), ("psa_b3584", (2, 3584, 64)),
    ("psa_b18944", (2, 18944, 64)), ("floor_d32", (1, 32, 64)))
# the cluster route forced where the plan does not take it: one cluster
# (32 rows, mostly empty ranges: the route's floor) and 512 rows
QR_FORCED_CLUSTER = (("cl_floor_d32", (1, 32, 64)), ("cl_d512", (1, 512, 64)))
# source -> variant -> the ELL kernel's (band, halo) in place of the
# graph's own
HALO = {"ell_spmm": {"b64h2": (64, 2), "b32h0": (32, 0), "b32h8": (32, 8),
                     "b16h2": (16, 2), "b8h0": (8, 0)}}
# source -> variant -> row length: S-DOT's stack zero-padded to this many
# columns (the same work, another row stride), the kernel's own source
STRIDE = {"gram_update": {f"n{n}": n for n in (2504, 2512, 2528, 2560, 2592)}}
# source -> variant -> {module constant: value} for the wrapper
_BN8 = {"_TILE_COLS": (8,)}
PLAN = {"gram_update": {"bn8": _BN8, "stream_bn8": _BN8,
                        "packed_w12": {"PACKED_WARPS": 12},
                        "packed_w12_compute_only": {"PACKED_WARPS": 12},
                        "packed_w16": {"PACKED_WARPS": 16}},
        "slab_ops": {"c128": {"_TILE_COLS": (128,)},
                     "c64": {"_TILE_COLS": (64,)},
                     "stream_c128": {"_TILE_COLS": (128,)}},
        "gram_qr": {**{f"range{b}": {"MIN_RANGE_BYTES": b}
                       for b in _QR_RANGES}, **_QR_CLUSTER_PLANS},
}


def build(names, out: Path):
    """Build the variants ``names`` ((source, variant) pairs) -> ({pair:
    library path}, {pair: why skipped})."""
    from repro_torch.kernels import _build

    procs, skipped = {}, {}
    for source, variant in names:
        text = (_build.CSRC / f"{source}.cu").read_text()
        header = (_build.CSRC / "hopper.cuh").read_text()
        missing = [a for a, _ in VARIANTS[source][variant]
                   if a not in text and a not in header]
        if missing:
            skipped[(source, variant)] = (f"lines not in the sources: "
                                          f"{missing[0][:60]!r}")
            continue
        for a, b in VARIANTS[source][variant]:
            text, header = text.replace(a, b), header.replace(a, b)
        where = out / f"{source}_{variant}"
        where.mkdir(parents=True, exist_ok=True)
        (where / "hopper.cuh").write_text(header)
        cu = where / f"{source}.cu"
        cu.write_text(text)
        lib = where / f"lib{source}.so"
        procs[(source, variant)] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        built[key] = lib
    return built, skipped


def lane_fold_times(rounds: int) -> None:
    """The ``--lane-fold`` timings: one JSON line a kernel and round, then
    the medians with the card's name and power limit."""
    import torch
    from chip_smoke import nvidia_smi, time_ms
    from repro_torch.core.fdot import pad_feature_slabs
    from repro_torch.core.sdot import _stack_data
    from repro_torch.data.pipeline import (gaussian_eigengap_data,
                                           partition_features,
                                           partition_samples)
    from repro_torch.kernels import _launch, gram_update, ops, ref, slab_ops

    dev = torch.device("cuda")
    d, r, nodes, n_total = 1024, 7, 20, 50_000
    x, _, _ = gaussian_eigengap_data(d, n_total, r, 0.7, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x_stack, n_true = _stack_data(partition_samples(x, nodes), dev)
    x_pad = pad_feature_slabs(partition_features(x, nodes))
    q_lanes = torch.randn((12, nodes, d, r), generator=gen, device=dev)
    fq_lanes = torch.randn((4, nodes, x_pad.shape[1], r), generator=gen,
                           device=dev)
    s_lanes = torch.randn((4, nodes, n_total, r), generator=gen, device=dev)
    card = _launch.card(torch.cuda.current_device())

    def widest(planner, lanes, x_):
        """The most lanes whose columns the kernel takes and ``planner``
        (None: no planner) admits."""
        for g in range(min(lanes, slab_ops.MAX_R // r), 0, -1):
            try:
                if planner is not None:
                    planner(*x_.shape, g * r, *card)
            except ValueError:
                continue
            return g
        raise ValueError("no fold plans")

    def folded(launch, y, g):
        """``launch`` over groups of g lanes folded into the columns."""
        parts = []
        for a in range(0, y.shape[0], g):
            part = y[a:a + g]
            cols = part.permute(1, 2, 0, 3).reshape(nodes, part.shape[2], -1)
            out = launch(cols.contiguous())
            parts.append(out.reshape(nodes, out.shape[1], part.shape[0], r)
                         .permute(2, 0, 1, 3))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    cases = {
        "gram_apply": (
            gram_update.plan, x_stack, q_lanes,
            lambda y: ops.batched_gram_apply(x_stack, y, n_true),
            lambda: ops.lane_gram_apply(x_stack, q_lanes, n_true),
            torch.stack([ref.batched_gram_apply_ref(x_stack, q, n_true)
                         for q in q_lanes])),
        "slab_tq": (
            None, x_pad, fq_lanes, lambda y: ops.batched_slab_tq(x_pad, y),
            lambda: torch.stack([ops.batched_slab_tq(x_pad, q)
                                 for q in fq_lanes]),
            torch.stack([ref.batched_slab_tq_ref(x_pad, q)
                         for q in fq_lanes])),
        "slab_apply": (
            slab_ops.apply_plan, x_pad, s_lanes,
            lambda y: ops.batched_slab_apply(x_pad, y),
            lambda: ops.lane_slab_apply(x_pad, s_lanes),
            torch.stack([ref.batched_slab_apply_ref(x_pad, s)
                         for s in s_lanes]))}
    runs = {}
    for rnd in range(rounds):
        for kind, (planner, x_, y, launch, one, want) in cases.items():
            g = widest(planner, y.shape[0], x_)
            fold = lambda: folded(launch, y, g)  # noqa: E731
            for route, fn in (("fold", fold), ("one_a_lane", one)):
                ms = time_ms(fn, reps=5)
                got = fn()
                torch.cuda.synchronize()
                err = float((got - want).abs().max() / want.abs().max())
                runs.setdefault(f"{kind}:{route}", []).append(ms)
                print(json.dumps({"kernel": kind, "lanes": y.shape[0],
                                  "route": route, "lanes_a_launch":
                                  g if route == "fold" else 1,
                                  "round": rnd, "ms": ms, "rel_err": err}),
                      flush=True)
    print(json.dumps({"card": nvidia_smi(), "median_ms": {
        k: statistics.median(v) for k, v in runs.items()}}), flush=True)


# (grid blocks a stage, ring stages, row slices, lanes a unit group) of the
# packed grid kernels at bdot_sparse's grid; the first is the planner's
PACKED_PLANS = {
    "apply": [(8, 2, 1, 4), (4, 4, 2, 4), (2, 8, 4, 4), (6, 2, 1, 4),
              (4, 3, 2, 4), (3, 6, 2, 4)],
    "tq": [(8, 2, 1, 4), (4, 4, 1, 2), (2, 8, 1, 1), (6, 2, 1, 4),
           (4, 3, 1, 2)]}


def packed_plan_times(rounds: int) -> None:
    """The ``--packed-plans`` timings: one JSON line a kernel, plan and
    round, then the medians with the card's name and power limit."""
    import dataclasses

    import torch
    from chip_smoke import nvidia_smi, time_ms
    from repro_torch.kernels import _launch, ref, slab_ops

    dev = torch.device("cuda")
    card = _launch.card(torch.cuda.current_device())
    blocks, j_cols, d, n, r = 16_384, 4096, 196, 16, 5
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((blocks, d, n), generator=gen, device=dev)
    q = torch.randn((4, d, r), generator=gen, device=dev)
    s = torch.randn((j_cols, n, r), generator=gen, device=dev)
    planner = slab_ops.packed_layout
    runs = {}
    try:
        for kernel, fn, y, plain in (
                ("apply", slab_ops.slab_apply_cuda, s,
                 ref.grid_block_apply_ref),
                ("tq", slab_ops.slab_tq_cuda, q, ref.grid_block_tq_ref)):
            base = planner(kernel, blocks, j_cols, d, n, r, *card)
            want = plain(x.view(4, j_cols, d, n), y).reshape(blocks, -1, r)
            for rnd in range(rounds):
                for v in PACKED_PLANS[kernel] + PACKED_PLANS[kernel][::-1]:
                    g, stages, slices, lanes = v
                    smem = slab_ops.packed_smem_bytes(kernel, g, d, n, r,
                                                      stages)
                    if smem + slab_ops.STATIC_SMEM > card[1]:
                        continue
                    p = dataclasses.replace(
                        base, blocks_per_stage=g, stages=stages,
                        row_slices=slices, unit_lanes=lanes, smem=smem)
                    slab_ops.packed_layout = lambda *a, p=p: p
                    slab_ops._device_packed_plan.cache_clear()
                    got = fn(x, y, j_cols)
                    err = float((got - want).abs().max()
                                / want.abs().max())
                    ms = time_ms(lambda: fn(x, y, j_cols))
                    runs.setdefault(f"{kernel}:{v}", []).append(ms)
                    print(json.dumps({"kernel": kernel, "plan": v,
                                      "planner": v == PACKED_PLANS[kernel][0],
                                      "round": rnd, "ms": ms,
                                      "rel_err": err}), flush=True)
    finally:
        slab_ops.packed_layout = planner
        slab_ops._device_packed_plan.cache_clear()
    print(json.dumps({"card": nvidia_smi(), "median_ms": {
        k: statistics.median(v) for k, v in runs.items()}}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append",
                    help="SOURCE:VARIANT to time beside the kernels "
                         "(default: all)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--lane-fold", action="store_true",
                    help="time a sweep's lanes folded into the kernels' "
                         "columns against one launch a lane, and nothing "
                         "else")
    ap.add_argument("--packed-plans", action="store_true",
                    help="time the grid kernels' packed route under other "
                         "plans than the planner's, and nothing else")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("psa_kernel_variants: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    if args.lane_fold:
        lane_fold_times(args.rounds)
        return
    if args.packed_plans:
        packed_plan_times(args.rounds)
        return
    from chip_smoke import nvidia_smi, time_ms
    from repro_torch.core.bdot import pad_grid_blocks
    from repro_torch.core.fdot import pad_feature_slabs
    from repro_torch.core.sdot import _stack_data
    from repro_torch.data.pipeline import (gaussian_eigengap_data,
                                           partition_features,
                                           partition_samples)
    from repro_torch.core import topology
    from repro_torch.core.sparse import SparseW
    from repro_torch.kernels import (ell_spmm, gram_qr, gram_update, ops,
                                     ref, slab_ops)

    names = [tuple(v.split(":")) for v in args.variant] if args.variant else [
        (src, v) for src, vs in VARIANTS.items() for v in vs]
    strides = [(src, v) for src, v in names
               if v in STRIDE.get(src, {}) or v in HALO.get(src, {})]
    names = [key for key in names if key not in strides]
    names = sorted(set(names) | {(src, "kernel") for src, _ in names + strides})
    built, skipped = build(names, ROOT / "build" / "psa_variants")
    for key, why in skipped.items():
        print(json.dumps({"variant": ":".join(key), "skipped": why}),
              flush=True)

    dev = torch.device("cuda")
    d, r, nodes, n_total = 1024, 7, 20, 50_000
    x, _, _ = gaussian_eigengap_data(d, n_total, r, 0.7, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x_stack, n_true = _stack_data(partition_samples(x, nodes), dev)
    q_stack = torch.linalg.qr(torch.randn((nodes, d, r), generator=gen,
                                          device=dev))[0].contiguous()
    x_one, q_one = x_stack[0, :, :2500].contiguous(), q_stack[0]
    # sdot_sparse's stack: 4,096 nodes of 784 x 14-15 samples, padded to 16
    xs, _, _ = gaussian_eigengap_data(784, 60_000, 5, 0.7, seed=0,
                                      device=dev)
    x_sp, n_sp = _stack_data(partition_samples(xs, 4096), dev)
    del xs
    q_sp = torch.linalg.qr(torch.randn((4096, 784, 5), generator=gen,
                                       device=dev))[0].contiguous()
    x_pad = pad_feature_slabs(partition_features(x, nodes))
    s_slab = torch.randn((nodes, n_total, r), generator=gen, device=dev)
    x_grid = pad_grid_blocks([partition_samples(sl, 5)
                              for sl in partition_features(x, 4)])
    s_grid = torch.randn((5, x_grid.shape[3], r), generator=gen, device=dev)
    cases = {
        "gram_update": {
            "batched_gram_apply": (
                lambda: ops.batched_gram_apply(x_stack, q_stack, n_true),
                ref.batched_gram_apply_ref(x_stack, q_stack, n_true)),
            "gram_apply": (lambda: ops.gram_apply(x_one, q_one),
                           ref.gram_apply_ref(x_one, q_one)),
            "batched_gram_apply_sp": (
                lambda: ops.batched_gram_apply(x_sp, q_sp, n_sp),
                ref.batched_gram_apply_ref(x_sp, q_sp, n_sp))},
        "slab_ops": {
            "batched_slab_apply": (
                lambda: ops.batched_slab_apply(x_pad, s_slab),
                ref.batched_slab_apply_ref(x_pad, s_slab)),
            "grid_block_apply": (
                lambda: ops.grid_block_apply(x_grid, s_grid),
                ref.grid_block_apply_ref(x_grid, s_grid))}}
    ell_z = torch.randn((4096, 3920), generator=gen, device=dev)
    ws = SparseW.from_graph(topology.watts_strogatz(4096, k=6, p=0.1, seed=1),
                            device=dev)
    er = SparseW.from_graph(topology.erdos_renyi(
        4096, 0.0015, seed=1, ensure_connected=False), device=dev)

    def ell_case(sw, payload, window=None):
        src = ell_z if payload is None else ell_z.to(torch.bfloat16)
        return (lambda: ops.ell_spmm(
                    sw.ell_idx, sw.ell_val, sw.diag, ell_z,
                    payload_dtype=payload,
                    window=sw.window if window is None else window),
                ref.ell_spmm_ref(sw.ell_idx, sw.ell_val, sw.diag, ell_z, src))
    cases["ell_spmm"] = {"ws": ell_case(ws, None),
                         "ws_bf16": ell_case(ws, "bfloat16"),
                         "er": ell_case(er, None)}
    cases["gram_qr"] = {}
    for label, shape, dtype in (
            ("sdot", (nodes, d, r), torch.float32),
            ("fdot", (nodes, 55, r), torch.float32),
            ("bdot", (4, 256, r), torch.float32),
            ("bench_f32", (1, 16384, 128), torch.float32),
            ("bench_bf16", (1, 16384, 128), torch.bfloat16),
            *((label, shape, torch.float32)
              for label, shape in QR_REFRESH_SHAPES)):
        vq = torch.randn(shape, generator=gen, device=dev).to(dtype)
        cases["gram_qr"][label] = (lambda vq=vq: ops.gram_qr(vq),
                                   ref.gram_qr_ref(vq))
    for label, shape in QR_FORCED_CLUSTER:
        vq = torch.randn(shape, generator=gen, device=dev)
        cases["gram_qr"][label] = (
            lambda vq=vq: gram_qr.gram_qr_cuda(vq, route="cluster"),
            ref.gram_qr_ref(vq))
    modules = {"gram_update": gram_update, "slab_ops": slab_ops,
               "gram_qr": gram_qr, "ell_spmm": ell_spmm}
    libs = {key: modules[key[0]]._typed(ctypes.CDLL(str(path)))
            for key, path in built.items()}
    for src, v in strides:
        if v in HALO.get(src, {}):
            cases[f"{src}:{v}"] = {
                name: ell_case(g, None, ell_spmm.WindowPlan(*HALO[src][v],
                                                            0, 1))
                for name, g in (("ws", ws), ("er", er))}
            libs[(src, v)] = libs[(src, "kernel")]
            continue
        width = STRIDE[src][v]
        xw = torch.nn.functional.pad(x_stack, (0, width - x_stack.shape[2]))
        cases.setdefault(f"{src}:{v}", {})["batched_gram_apply"] = (
            lambda xw=xw: ops.batched_gram_apply(xw, q_stack, n_true),
            cases[src]["batched_gram_apply"][1])
        libs[(src, v)] = libs[(src, "kernel")]
    real = {src: m._lib for src, m in modules.items()}
    planners = (gram_update.plan, gram_update._device_plan,
                gram_update.packed_layout, gram_update._device_packed_plan,
                slab_ops.apply_plan, slab_ops._device_apply_plan,
                gram_qr.plan, gram_qr._device_plan, ell_spmm.plan)
    runs = {}
    for rnd in range(args.rounds):
        for (source, variant), lib in libs.items():
            module = modules[source]
            module._lib = lambda lib=lib: lib
            saved = {k: getattr(module, k)
                     for k in PLAN.get(source, {}).get(variant, {})}
            for k, value in PLAN.get(source, {}).get(variant, {}).items():
                setattr(module, k, value)
            # a variant may leave its tickets set, or plan other tiles:
            # fresh tickets and plans for each
            getattr(module, "_WORK", {}).clear()
            for fn in planners:
                fn.cache_clear()
            for shape, (kernel, want) in cases.get(
                    f"{source}:{variant}", cases[source]).items():
                ms = time_ms(kernel)
                got = kernel()
                torch.cuda.synchronize()
                err = float((got - want).abs().max() / want.abs().max())
                runs.setdefault(f"{source}:{variant}:{shape}", []).append(ms)
                print(json.dumps({"variant": f"{source}:{variant}",
                                  "shape": shape, "round": rnd, "ms": ms,
                                  "rel_err": err}), flush=True)
            getattr(module, "_WORK", {}).clear()
            module._lib = real[source]
            for k, value in saved.items():
                setattr(module, k, value)
            for fn in planners:
                fn.cache_clear()
    print(json.dumps({"card": nvidia_smi(), "launch_floor_ms": time_ms(
        lambda: torch.cuda._sleep(1)), "median_ms": {
        k: statistics.median(v) for k, v in runs.items()}}), flush=True)


if __name__ == "__main__":
    main()
