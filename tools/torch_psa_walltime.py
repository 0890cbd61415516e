"""Wall time of the port's fused S-DOT, F-DOT and B-DOT on the card, for
one or more checkouts of this repository, with the runs interleaved.

    python3 tools/torch_psa_walltime.py [--tree DIR ...] [--rounds 1]
                                        [--reps 3]

Each ``--tree`` is the root of a checkout (default: this one). The trees run
in the order given and then in reverse, ``--rounds`` times over (A B B A for
two trees and one round), each in a fresh process that imports that tree's
``src/repro_torch``, builds its kernels and makes the data of chip_smoke.py's
main path: d = 1024, r = 7, 50,000 samples on 20 nodes of ER(20, 0.25),
F-DOT over 20 feature slabs, B-DOT over the 4 x 5 grid, T_o = 100 and
t_c = t_c_qr = 50. Each family runs once to warm up and then ``--reps`` times,
with the card synchronised before and after each run. One JSON line per
process, then a summary line: each tree's median and least wall time per
family, the card's name and power limit and, for two trees, the pairs: each round's processes pair up
(A B and B A), and for each family the summary counts the pairs the
second tree's median wall won and the quartile spread of the first
tree's process medians.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

FAMILIES = ("sdot", "fdot", "bdot")


def worker(tree: Path, reps: int) -> dict:
    import torch

    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core import topology
    from repro_torch.core.bdot import bdot
    from repro_torch.core.consensus import DenseConsensus
    from repro_torch.core.fdot import fdot
    from repro_torch.core.linalg import orthonormal_init
    from repro_torch.core.sdot import sdot
    from repro_torch.data.pipeline import (gaussian_eigengap_data,
                                           partition_features,
                                           partition_samples)
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    _build.build_all()
    d, r, n_nodes, n_total, t_outer = 1024, 7, 20, 50_000, 100
    x, _, q_true = gaussian_eigengap_data(d, n_total, r, 0.7, seed=0,
                                          device=dev)
    blocks = partition_samples(x, n_nodes)
    fslabs = partition_features(x, n_nodes)
    grid = [partition_samples(sl, 5) for sl in partition_features(x, 4)]
    eng = DenseConsensus(topology.erdos_renyi(n_nodes, 0.25, seed=1),
                         device=dev)
    col_engs = [DenseConsensus(topology.erdos_renyi(4, 0.7, seed=j),
                               device=dev) for j in range(5)]
    row_engs = [DenseConsensus(topology.erdos_renyi(5, 0.7, seed=10 + i),
                               device=dev) for i in range(4)]
    q_init = orthonormal_init(torch.Generator().manual_seed(0), d, r,
                              device=dev)
    common = dict(r=r, t_outer=t_outer, t_c=50, q_init=q_init,
                  q_true=q_true, device=dev)
    runs = {
        "sdot": lambda: sdot(data=blocks, engine=eng, **common),
        "fdot": lambda: fdot(data_blocks=fslabs, engine=eng, t_c_qr=50,
                             **common),
        "bdot": lambda: bdot(blocks=grid, col_engines=col_engs,
                             row_engines=row_engs, t_c_qr=50, **common)}
    out = {"tree": str(tree), "wall_s": {}, "final_err": {}}
    for fam in FAMILIES:
        runs[fam]()                                   # warm-up
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = runs[fam]()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out["wall_s"][fam] = walls
        out["final_err"][fam] = float(res.error_trace[-1])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.reps)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_psa_walltime: no CUDA device")
    trees = [t.resolve() for t in (args.tree
                                   or [Path(__file__).resolve().parents[1]])]
    walls = {str(t): {fam: [] for fam in FAMILIES} for t in trees}
    procs = []                      # (tree, {family: median wall}) in order
    for _ in range(args.rounds):
        for tree in trees + trees[::-1]:
            line = subprocess.run(
                [sys.executable, __file__, "--worker", str(tree), "--reps",
                 str(args.reps)], check=True, capture_output=True,
                text=True).stdout.strip().splitlines()[-1]
            print(line, flush=True)
            out = json.loads(line)
            for fam, w in out["wall_s"].items():
                walls[str(tree)][fam].extend(w)
            procs.append((str(tree), {fam: statistics.median(w)
                                      for fam, w in out["wall_s"].items()}))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()

    def per_tree(stat):
        return {t: {fam: stat(w) for fam, w in fams.items()}
                for t, fams in walls.items()}

    summary = {"card": card, "median_wall_s": per_tree(statistics.median),
               "min_wall_s": per_tree(min)}
    if len(trees) == 2:
        first = str(trees[0])
        pairs = [dict(procs[i:i + 2]) for i in range(0, len(procs), 2)]
        summary["pairs"] = {fam: {
            "n": len(pairs),
            "second_wins": sum(p[str(trees[1])][fam] < p[first][fam]
                               for p in pairs),
            "first_quartile_spread_s": (lambda q: q[2] - q[0])(
                statistics.quantiles([m[fam] for t, m in procs
                                      if t == first], n=4))}
            for fam in FAMILIES}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
