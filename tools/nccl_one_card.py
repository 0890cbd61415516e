"""Try NCCL with two ranks on one card, and print what it says.

    python3 tools/nccl_one_card.py

NCCL expects one card a rank, so two ranks on the same device are
expected to be refused (its duplicate-GPU check); ranks that share a card
use gloo with pinned host staging instead (src/repro_torch/launch/mesh.py).
This spawns 2 ranks with backend "nccl", both on cuda:0, runs one
all-reduce, and prints one JSON line: whether it worked and, if not, the
end of the error. It exits 0 either way, and 2 where there is no card.
"""
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist


def _rank(rank, world, dev):
    t = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return t.cpu().tolist()


def main() -> None:
    if not torch.cuda.is_available():
        print("nccl_one_card: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.launch.mesh import spawn_ranks

    out = {"backend": "nccl", "ranks": 2, "device": "cuda:0 for both",
           "card": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
    try:
        out["result"] = spawn_ranks(_rank, 2, backend="nccl",
                                    device="cuda:0", timeout_s=60)
        out["ok"] = True
    except Exception as err:           # the finding is the error text
        out["ok"] = False
        out["error_type"] = type(err).__name__
        out["error"] = str(err)[-3000:]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
