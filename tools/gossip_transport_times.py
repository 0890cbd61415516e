"""Time a gossip round across processes two ways, all ranks on one card.

    python3 tools/gossip_transport_times.py [--ranks 20] [--rounds 200]

gloo ranks sharing the card, each holding a (1024, 7) f32 block (the
paper's CIFAR-10 width, r = 7), on erdos_renyi(N, 0.25, seed=1) and on
ring(N):

* ``all_gather``: every block to every rank, then this rank's row of W
  against the stack, the block staged to pinned host memory and back each
  round (the reference's general-graph round);
* ``exchange``: the graph's neighbours only, in one ``batch_isend_irecv``,
  each round's exchange staged and its sum on the card
  (``SpmdConsensus.gossip_rounds`` under gloo).

Prints one JSON line: ms a round (the slowest rank's wall over the rounds)
and bytes staged a round a rank, with the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist


def _rank(rank, world, dev, rounds):
    from repro_torch.core import topology
    from repro_torch.core.consensus import SpmdConsensus
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(device=dev)
    z0 = torch.randn((1024, 7), generator=torch.Generator(
        device=dev).manual_seed(rank), device=dev)
    out = {}
    for name, graph in (("erdos_renyi",
                         topology.erdos_renyi(world, 0.25, seed=1)),
                        ("ring", topology.ring(world))):
        eng = SpmdConsensus(mesh, "nodes", graph=graph)
        row = eng._w[eng.index]

        def all_gather(z, n):
            for _ in range(n):
                z = torch.tensordot(row, eng.group.all_gather(z), dims=1)
            return z

        variants = {"all_gather": all_gather,
                    "exchange": eng.gossip_rounds}
        for label, fn in variants.items():
            fn(z0, 2)                                   # warm
            dist.barrier()
            torch.cuda.synchronize()
            staged = eng.host_staged_bytes
            t0 = time.perf_counter()
            fn(z0, rounds)
            torch.cuda.synchronize()
            out[f"{name}/{label}"] = {
                "ms_a_round": (time.perf_counter() - t0) / rounds * 1e3,
                "staged_bytes_a_round":
                    (eng.host_staged_bytes - staged) / rounds}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gossip_transport_times: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.launch.mesh import spawn_ranks

    res = spawn_ranks(_rank, args.ranks, backend="gloo", device="cuda",
                      args=(args.rounds,))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": card, "ranks": args.ranks, "rounds": args.rounds,
        "payload": [1024, 7], "backend": "gloo",
        "ms_a_round": {k: max(r[k]["ms_a_round"] for r in res)
                       for k in res[0]},
        "staged_bytes_a_round_rank0": {k: v["staged_bytes_a_round"]
                                       for k, v in res[0].items()}}),
        flush=True)


if __name__ == "__main__":
    main()
