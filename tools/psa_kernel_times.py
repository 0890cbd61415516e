"""Device time of the gram-apply, slab / grid, ELL and Gram kernels, at
chip_smoke.py's main-path shapes, for one or more checkouts of this
repository, in turns; and the crossover of the grid kernels' two routes.

    python3 tools/psa_kernel_times.py [--tree DIR ...] [--rounds 1]
        [--rows ROW,ROW]
    python3 tools/psa_kernel_times.py --crossover [grid|gram|qr|all]

Each ``--tree`` is the root of a checkout (default: this one). The trees run
in the order given and then in reverse, ``--rounds`` times over (A B B A for
two trees and one round), each in a fresh process that imports that tree's
``src/repro_torch`` and builds its kernels. The rows: ``batched_gram_apply``
on S-DOT's stack (20 x 1024 x 2500, r = 7), ``gram_apply`` on one node's
(1024, 2500) block, ``batched_slab_tq`` and ``batched_slab_apply`` on
F-DOT's (20, 55, 50000) slabs, ``grid_block_tq`` and ``grid_block_apply``
on B-DOT's (4, 5, 256, 10000) grid, and both grid kernels on bdot_sparse's
4 x 4,096 grid of 196 x 16 blocks (``grid_block_tq_bs``,
``grid_block_apply_bs``: sdot_sparse's 784 x 60,000 data, cut as
chip_smoke.py cuts it), on the data of chip_smoke.py; one ELL gossip round (``SparseW.mix``) over a (4096, 3920)
payload on watts_strogatz(4096, 6, 0.1, seed 1) in f32 and with bf16
messages, and on erdos_renyi(4096, 0.0015, seed 1, not resampled until
connected) in f32 and bf16; and the CholeskyQR Gram (``ops.gram_qr``) at
chip_smoke.py's five shapes (S-DOT (20, 1024, 7), F-DOT (20, 55, 7), B-DOT
(4, 256, 7) and (1, 16384, 128) in f32 and bf16), at (1, 16384, 7)
in f32 (four ranges of r = 7 folded in one launch), and at the PSA
trainer's refresh shapes (``gram_qr_psa_*``: (1, 3584 / 4096 / 6400, 64)
and (2, 3584 / 18944, 64) in f32). For each: device time
a launch as chip_smoke.py takes it (CUDA events around 20 launches behind a
spin of the card, median of 5), the
host's time to issue one call, the largest error relative to the plain
version's max |V| and whether a second launch repeats the bits. One JSON
line a process, then a summary: each tree's median ms a row, and the card's
name and power limit.

``--crossover`` times the grid kernels of this tree alone, each route
forced (``route="packed"`` / ``"tiled"``), beside the library call
(``torch.matmul``), at n in 4, 8, ..., 256 samples a block with d = 196,
r = 5 and X kept at about 200 MB (I = 4 grid rows, J = B / 4), as the
kernel table times them; a route that cannot take a shape reads null. One
JSON line an n, then the card. ``slab_ops.PACKED_MAX_N`` is set from these
readings. ``--crossover gram`` does the same for the gram-apply kernel's
two routes (``gram_update.batched_gram_apply_cuda(route=...)``) beside the
``torch.bmm`` pair, at n in GRAM_CROSSOVER_N with d = 784 and 1024, r = 5
and 7, and 4,096 and 20 nodes (every column real); one JSON line a shape.
``gram_update.PACKED_MAX_N`` is set from these readings. ``--crossover
qr`` does the same for the CholeskyQR Gram's routes
(``gram_qr.gram_qr_cuda(route=...)``: the staged ``simt`` route and the
``cluster`` route) beside ``torch.matmul(v.mT, v)``, at d in QR_CROSSOVER_D,
r in QR_CROSSOVER_R and B in QR_CROSSOVER_B in f32, and in bf16 where the
type's route is ``simt`` (r = 16); first how many clusters of 16 and of
8 blocks the card holds at once (``gram_qr.cluster_occupancy`` at (1,
4096, 64)), then one JSON line a shape, with the route the plan takes.
``gram_qr.takes_cluster`` is set from these readings.
``--crossover`` alone (``all``) runs all three.

The row ``batched_gram_apply_sp`` times row 1 at sdot_sparse's own stack
(4,096 nodes of 784 x 14-15 samples padded to 16, r = 5), cut as
chip_smoke.py cuts it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = ("batched_gram_apply", "batched_gram_apply_sp", "gram_apply",
        "batched_slab_tq",
        "batched_slab_apply", "grid_block_tq", "grid_block_apply", "grid_block_tq_bs",
        "grid_block_apply_bs", "ell_spmm_ws", "ell_spmm_ws_bf16", "ell_spmm_er",
        "ell_spmm_er_bf16", "gram_qr_sdot", "gram_qr_fdot", "gram_qr_bdot",
        "gram_qr_bench_f32", "gram_qr_bench_bf16", "gram_qr_tall7",
        "gram_qr_psa_a3584", "gram_qr_psa_a4096", "gram_qr_psa_a6400",
        "gram_qr_psa_b3584", "gram_qr_psa_b18944")


def worker(tree: Path, only=None) -> dict:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core import topology
    from repro_torch.core.bdot import pad_grid_blocks
    from repro_torch.core.fdot import pad_feature_slabs
    from repro_torch.core.sdot import _stack_data
    from repro_torch.core.sparse import SparseW
    from repro_torch.data.pipeline import (gaussian_eigengap_data,
                                           partition_features,
                                           partition_samples)
    from repro_torch.kernels import _build, ops, ref

    dev = torch.device("cuda")
    _build.build_all()
    d, r, nodes, n_total = 1024, 7, 20, 50_000
    x, _, _ = gaussian_eigengap_data(d, n_total, r, 0.7, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x_stack, n_true = _stack_data(partition_samples(x, nodes), dev)
    q_stack = torch.linalg.qr(torch.randn((nodes, d, r), generator=gen,
                                          device=dev))[0].contiguous()
    x_one, q_one = x_stack[0, :, :2500].contiguous(), q_stack[0]
    x_pad = pad_feature_slabs(partition_features(x, nodes))
    s_slab = torch.randn((nodes, n_total, r), generator=gen, device=dev)
    q_pad = torch.randn((nodes, x_pad.shape[1], r), generator=gen,
                        device=dev)
    x_grid = pad_grid_blocks([partition_samples(sl, 5)
                              for sl in partition_features(x, 4)])
    s_grid = torch.randn((5, x_grid.shape[3], r), generator=gen, device=dev)
    q_grid = torch.randn((4, x_grid.shape[2], r), generator=gen, device=dev)
    xs, _, _ = gaussian_eigengap_data(784, 60_000, 5, 0.7, seed=0,
                                      device=dev)
    x_bs = pad_grid_blocks([partition_samples(sl, 4096)
                            for sl in partition_features(xs, 4)], 4)
    x_sp, n_sp = _stack_data(partition_samples(xs, 4096), dev)
    del xs
    q_sp = torch.linalg.qr(torch.randn((4096, 784, 5), generator=gen,
                                       device=dev))[0].contiguous()
    q_bs = torch.randn((4, x_bs.shape[2], 5), generator=gen, device=dev)
    s_bs = torch.randn((4096, x_bs.shape[3], 5), generator=gen, device=dev)
    cases = {
        "batched_gram_apply": (
            lambda: ops.batched_gram_apply(x_stack, q_stack, n_true),
            lambda: ref.batched_gram_apply_ref(x_stack, q_stack, n_true)),
        "batched_gram_apply_sp": (
            lambda: ops.batched_gram_apply(x_sp, q_sp, n_sp),
            lambda: ref.batched_gram_apply_ref(x_sp, q_sp, n_sp)),
        "gram_apply": (lambda: ops.gram_apply(x_one, q_one),
                       lambda: ref.gram_apply_ref(x_one, q_one)),
        "batched_slab_tq": (
            lambda: ops.batched_slab_tq(x_pad, q_pad),
            lambda: ref.batched_slab_tq_ref(x_pad, q_pad)),
        "batched_slab_apply": (
            lambda: ops.batched_slab_apply(x_pad, s_slab),
            lambda: ref.batched_slab_apply_ref(x_pad, s_slab)),
        "grid_block_tq": (
            lambda: ops.grid_block_tq(x_grid, q_grid),
            lambda: ref.grid_block_tq_ref(x_grid, q_grid)),
        "grid_block_apply": (
            lambda: ops.grid_block_apply(x_grid, s_grid),
            lambda: ref.grid_block_apply_ref(x_grid, s_grid)),
        "grid_block_tq_bs": (
            lambda: ops.grid_block_tq(x_bs, q_bs),
            lambda: ref.grid_block_tq_ref(x_bs, q_bs)),
        "grid_block_apply_bs": (
            lambda: ops.grid_block_apply(x_bs, s_bs),
            lambda: ref.grid_block_apply_ref(x_bs, s_bs))}
    z = torch.randn((4096, 3920), generator=gen, device=dev)
    for name, graph in (
            ("ws", topology.watts_strogatz(4096, k=6, p=0.1, seed=1)),
            ("er", topology.erdos_renyi(4096, 0.0015, seed=1,
                                        ensure_connected=False))):
        for payload in (None, "bfloat16"):
            sw = SparseW.from_graph(graph, payload_dtype=payload, device=dev)
            src = z if payload is None else z.to(torch.bfloat16)
            cases[f"ell_spmm_{name}" + ("_bf16" if payload else "")] = (
                lambda sw=sw: sw.mix(z),
                lambda sw=sw, src=src: ref.ell_spmm_ref(
                    sw.ell_idx, sw.ell_val, sw.diag, z, src))
    for label, shape, dtype in (
            ("sdot", (nodes, d, r), torch.float32),
            ("fdot", (nodes, 55, r), torch.float32),
            ("bdot", (4, 256, r), torch.float32),
            ("bench_f32", (1, 16384, 128), torch.float32),
            ("bench_bf16", (1, 16384, 128), torch.bfloat16),
            ("tall7", (1, 16384, 7), torch.float32),
            ("psa_a3584", (1, 3584, 64), torch.float32),
            ("psa_a4096", (1, 4096, 64), torch.float32),
            ("psa_a6400", (1, 6400, 64), torch.float32),
            ("psa_b3584", (2, 3584, 64), torch.float32),
            ("psa_b18944", (2, 18944, 64), torch.float32)):
        vq = torch.randn(shape, generator=gen, device=dev).to(dtype)
        cases[f"gram_qr_{label}"] = (lambda vq=vq: ops.gram_qr(vq),
                                     lambda vq=vq: ref.gram_qr_ref(vq))
    out = {"tree": str(tree), "rows": {},
           "launch_floor_ms": cs.time_ms(lambda: torch.cuda._sleep(1))}
    for name, (kernel, plain) in cases.items():
        if only and name not in only:
            continue
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        out["rows"][name] = {
            "ms": cs.time_ms(kernel), "host_us": cs.host_us(kernel),
            "rel_err": float((got - want).abs().max()
                             / want.abs().max()),
            "same_bits": bool(torch.equal(got, again))}
    return out


CROSSOVER_N = (4, 8, 16, 32, 64, 128, 256)


def crossover() -> None:
    """Both routes of the grid kernels, forced, and the library call at
    each n of CROSSOVER_N (d = 196, r = 5, ~200 MB of X)."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, _launch, slab_ops

    dev = torch.device("cuda")
    _build.build_all()
    card = _launch.card(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    d, r, i_rows = 196, 5, 4
    for n in CROSSOVER_N:
        blocks = 200_000_000 // (4 * d * n) // i_rows * i_rows
        j_cols = blocks // i_rows
        x = torch.randn((blocks, d, n), generator=gen, device=dev)
        q = torch.randn((i_rows, d, r), generator=gen, device=dev)
        s = torch.randn((j_cols, n, r), generator=gen, device=dev)
        xg = x.view(i_rows, j_cols, d, n)
        line = {"n": n, "blocks": blocks, "x_bytes": 4 * x.numel()}
        for kernel, fn, y, library, out in (
                ("tq", slab_ops.slab_tq_cuda, q,
                 lambda: torch.matmul(xg.mT, q[:, None]), blocks * n * r),
                ("apply", slab_ops.slab_apply_cuda, s,
                 lambda: torch.matmul(xg, s[None]), blocks * d * r)):
            row = {"route": slab_ops.packed_plan(
                       kernel, blocks, j_cols, d, n, r, *card).route,
                   "bound_ms": cs.bound(4 * (x.numel() + y.numel() + out),
                                        2.0 * x.numel() * r)[0],
                   "library_ms": cs.time_ms(library)}
            got = {}
            for route in ("packed", "tiled"):
                try:
                    got[route] = fn(x, y, j_cols, route=route)
                except ValueError as err:       # this route cannot take it
                    row[f"{route}_ms"], row[f"{route}_refused"] = None, str(
                        err)
                    continue
                row[f"{route}_ms"] = cs.time_ms(
                    lambda route=route: fn(x, y, j_cols, route=route))
            if len(got) == 2:
                a, b = got["packed"], got["tiled"]
                row["rel_diff"] = float((a - b).abs().max()
                                        / b.abs().max())
            line[kernel] = row
            del got
        print(json.dumps(line), flush=True)
        del x, q, s, xg
        torch.cuda.empty_cache()
    print(json.dumps({"card": cs.nvidia_smi()}), flush=True)


GRAM_CROSSOVER_N = (4, 8, 12, 14, 16, 20, 24, 28, 32)


def gram_crossover() -> None:
    """Both routes of the gram-apply kernel, forced, and the ``torch.bmm``
    pair at each n of GRAM_CROSSOVER_N, d = 784 and 1024, r = 5 and 7,
    4,096 and 20 nodes."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, _launch, gram_update

    dev = torch.device("cuda")
    _build.build_all()
    card = _launch.card(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    fn = gram_update.batched_gram_apply_cuda
    for nodes in (4096, 20):
        for d in (784, 1024):
            for r in (5, 7):
                for n in GRAM_CROSSOVER_N:
                    x = torch.randn((nodes, d, n), generator=gen, device=dev)
                    q = torch.randn((nodes, d, r), generator=gen, device=dev)
                    nt = torch.full((nodes,), float(n), device=dev)
                    line = {"nodes": nodes, "d": d, "n": n, "r": r,
                            "route": gram_update.packed_plan(
                                nodes, d, n, r, *card).route,
                            "bound_ms": cs.bound(
                                4 * (x.numel() + 2 * q.numel() + nodes),
                                4.0 * x.numel() * r)[0],
                            "library_ms": cs.time_ms(
                                lambda: torch.bmm(x, torch.bmm(x.mT, q)))}
                    got = {}
                    for route in ("packed", "tiled"):
                        try:
                            got[route] = fn(x, q, nt, route=route)
                        except ValueError as err:   # cannot take the shape
                            line[f"{route}_ms"] = None
                            line[f"{route}_refused"] = str(err)
                            continue
                        line[f"{route}_ms"] = cs.time_ms(
                            lambda route=route: fn(x, q, nt, route=route))
                    if len(got) == 2:
                        a, b = got["packed"], got["tiled"]
                        line["rel_diff"] = float((a - b).abs().max()
                                                 / b.abs().max())
                    print(json.dumps(line), flush=True)
                    del x, q, nt, got
                    torch.cuda.empty_cache()
    print(json.dumps({"card": cs.nvidia_smi()}), flush=True)


QR_CROSSOVER_D = (512, 1024, 2048, 3584, 4096, 6400, 8192, 12288, 18944,
                  20000)
QR_CROSSOVER_R = (16, 32, 48, 64, 128)
QR_CROSSOVER_B = (1, 2, 4, 20)


def qr_crossover() -> None:
    """The Gram's staged and cluster routes, forced, and the library call
    at each (B, d, r) of the QR_CROSSOVER grids (f32; bf16 at r = 16)."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, _launch, gram_qr

    dev = torch.device("cuda")
    _build.build_all()
    sm = _launch.card(0)[0]
    occupancy = {}
    for size in (gram_qr.CLUSTER, 8):
        saved, gram_qr.CLUSTER = gram_qr.CLUSTER, size
        gram_qr.plan.cache_clear()
        gram_qr._device_plan.cache_clear()
        occupancy[size] = gram_qr.cluster_occupancy(1, 4096, 64)
        gram_qr.CLUSTER = saved
    gram_qr.plan.cache_clear()
    gram_qr._device_plan.cache_clear()
    print(json.dumps({"clusters_at_once": occupancy}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(b, d, r, dtype) for dtype in (torch.float32, torch.bfloat16)
              for b in QR_CROSSOVER_B for r in QR_CROSSOVER_R
              for d in QR_CROSSOVER_D
              if gram_qr.route(r, dtype == torch.bfloat16) == "simt"]
    for b, d, r, dtype in shapes:
        v = torch.randn((b, d, r), generator=gen, device=dev).to(dtype)
        is_bf16 = dtype == torch.bfloat16
        line = {"batch": b, "d": d, "r": r,
                "dtype": str(dtype).removeprefix("torch."),
                "route": gram_qr.plan(b, d, r, is_bf16, sm).route,
                "bound_ms": cs.bound(v.numel() * v.element_size()
                                     + 4 * b * r * r,
                                     float(b * d * r * (r + 1)))[0],
                "library_ms": cs.time_ms(lambda: torch.matmul(v.mT, v))}
        got = {}
        for route in ("simt", "cluster"):
            try:
                got[route] = gram_qr.gram_qr_cuda(v, route=route)
            except ValueError as err:        # this route cannot take it
                line[f"{route}_ms"], line[f"{route}_refused"] = None, str(
                    err)
                continue
            line[f"{route}_ms"] = cs.time_ms(
                lambda route=route: gram_qr.gram_qr_cuda(v, route=route))
        if len(got) == 2:
            a, c = got["simt"], got["cluster"]
            line["rel_diff"] = float((a - c).abs().max() / a.abs().max())
        print(json.dumps(line), flush=True)
        del v, got
    print(json.dumps({"card": cs.nvidia_smi()}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--rows", help="comma-separated rows to time (default: "
                    "all)")
    ap.add_argument("--crossover", nargs="?", const="all",
                    choices=("all", "grid", "gram", "qr"),
                    help="time the grid (gram-apply, Gram) kernels' "
                         "routes against their shapes")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = args.rows.split(",") if args.rows else None
    if args.worker is not None:
        print(json.dumps(worker(args.worker, only)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("psa_kernel_times: no CUDA device")
    if args.crossover:
        if args.crossover in ("all", "grid"):
            crossover()
        if args.crossover in ("all", "gram"):
            gram_crossover()
        if args.crossover in ("all", "qr"):
            qr_crossover()
        return
    trees = [t.resolve() for t in (args.tree or [ROOT])]
    ms = {str(t): {row: [] for row in only or ROWS} for t in trees}
    for _ in range(args.rounds):
        for tree in trees + trees[::-1]:
            line = subprocess.run(
                [sys.executable, __file__, "--worker", str(tree)]
                + (["--rows", args.rows] if only else []), check=True,
                capture_output=True, text=True).stdout.strip().splitlines()[-1]
            print(line, flush=True)
            for row, res in json.loads(line)["rows"].items():
                ms[str(tree)][row].append(res["ms"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({"card": card, "median_ms": {
        t: {row: statistics.median(v) for row, v in rows.items()}
        for t, rows in ms.items()}}))


if __name__ == "__main__":
    main()
