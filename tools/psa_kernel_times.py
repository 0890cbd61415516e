"""Device time of the gram-apply and slab-apply kernels, at chip_smoke.py's
main-path shapes, for one or more checkouts of this repository, in turns.

    python3 tools/psa_kernel_times.py [--tree DIR ...] [--rounds 1]

Each ``--tree`` is the root of a checkout (default: this one). The trees run
in the order given and then in reverse, ``--rounds`` times over (A B B A for
two trees and one round), each in a fresh process that imports that tree's
``src/repro_torch`` and builds its kernels. The rows: ``batched_gram_apply``
on S-DOT's stack (20 x 1024 x 2500, r = 7), ``gram_apply`` on one node's
(1024, 2500) block, ``batched_slab_apply`` on F-DOT's (20, 55, 50000) slabs
and ``grid_block_apply`` on B-DOT's (4, 5, 256, 10000) grid, on the data of
chip_smoke.py. For each: device time a launch as chip_smoke.py takes it
(CUDA events around 20 launches behind a spin of the card, median of 5), the
host's time to issue one call, the largest error relative to the plain
version's max |V| and whether a second launch repeats the bits. One JSON
line a process, then a summary: each tree's median ms a row, and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = ("batched_gram_apply", "gram_apply", "batched_slab_apply",
        "grid_block_apply")


def worker(tree: Path) -> dict:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core.bdot import pad_grid_blocks
    from repro_torch.core.fdot import pad_feature_slabs
    from repro_torch.core.sdot import _stack_data
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
    x_grid = pad_grid_blocks([partition_samples(sl, 5)
                              for sl in partition_features(x, 4)])
    s_grid = torch.randn((5, x_grid.shape[3], r), generator=gen, device=dev)
    cases = {
        "batched_gram_apply": (
            lambda: ops.batched_gram_apply(x_stack, q_stack, n_true),
            lambda: ref.batched_gram_apply_ref(x_stack, q_stack, n_true)),
        "gram_apply": (lambda: ops.gram_apply(x_one, q_one),
                       lambda: ref.gram_apply_ref(x_one, q_one)),
        "batched_slab_apply": (
            lambda: ops.batched_slab_apply(x_pad, s_slab),
            lambda: ref.batched_slab_apply_ref(x_pad, s_slab)),
        "grid_block_apply": (
            lambda: ops.grid_block_apply(x_grid, s_grid),
            lambda: ref.grid_block_apply_ref(x_grid, s_grid))}
    out = {"tree": str(tree), "rows": {}}
    for name, (kernel, plain) in cases.items():
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        out["rows"][name] = {
            "ms": cs.time_ms(kernel), "host_us": cs.host_us(kernel),
            "rel_err": float((got - want).abs().max()
                             / want.abs().max()),
            "same_bits": bool(torch.equal(got, again))}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("psa_kernel_times: no CUDA device")
    trees = [t.resolve() for t in (args.tree or [ROOT])]
    ms = {str(t): {row: [] for row in ROWS} for t in trees}
    for _ in range(args.rounds):
        for tree in trees + trees[::-1]:
            line = subprocess.run(
                [sys.executable, __file__, "--worker", str(tree)], check=True,
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
