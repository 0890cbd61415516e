"""Find where the reference's one-pass CholeskyQR breaks down on the example's
own training trajectory, and save that gradient as a test input.

    python3 tools/refresh_breakdown_capture.py [--steps 33] [--out PATH]

Trains the example twin's ``--full-100m`` config (train_lm_psa_compress.py)
on 2 gloo pod ranks sharing the card. Before every refresh, pod 0 runs the
reference's refresh arithmetic alone on each compressed leaf's groups: per
OI iteration Z = G (G^T Q), then one CholeskyQR pass on Z^T Z + 1e-12 I
(``repro/optim/psa_compress.py``'s ``cqr``), in f32 on the card, with no
pods to average over. At the first refresh where some group's Cholesky
fails or its Q comes out non-finite, it saves the smallest such group's
gradient and entering projector (f32) to ``--out`` (npz) and the run goes
on to ``--steps``. Prints one JSON line: every refresh's worst one-pass
orthonormality error, the case saved, and the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def one_pass_refresh(g: torch.Tensor, q: torch.Tensor, oi_iters: int):
    """(q, cholesky_failed): the reference's refresh of one (a, b) leaf with
    no pods, each CholeskyQR one pass on Z^T Z + 1e-12 I."""
    failed = False
    eye = torch.eye(q.shape[-1], device=q.device)
    for _ in range(oi_iters):
        z = g @ (q.mT @ g).mT
        low, info = torch.linalg.cholesky_ex(z.mT @ z + 1e-12 * eye)
        failed |= bool(info > 0)
        q = torch.linalg.solve_triangular(low.mT, z, upper=True, left=False)
    return q, failed


def _rank(rank, world, dev, targs, cfg, out_path):
    import repro_torch.train.step as step_mod
    from repro_torch import _tree
    from repro_torch.launch.train import train

    inner = step_mod.psa_refresh
    log = {"refreshes": [], "saved": None}

    def hooked(grads, psa_state, psa, **kw):
        if rank == 0:
            names, gl, _ = _tree.flatten_with_names(grads)
            projs = dict(zip(*_tree.flatten_with_names(psa_state["proj"])
                             [:2]))
            worst, bad = 0.0, []
            for name, g in zip(names, gl):
                p = projs.get(name)
                if p is None:
                    continue
                g32 = g.float()
                stack = g32 if p.dim() == 3 else g32[None]
                pst = p if p.dim() == 3 else p[None]
                for k in range(stack.shape[0]):
                    q, failed = one_pass_refresh(stack[k], pst[k],
                                                 psa.oi_iters)
                    err = float((q.mT @ q - torch.eye(
                        q.shape[-1], device=q.device)).abs().max())
                    finite = bool(torch.isfinite(q).all())
                    worst = max(worst, err if finite else float("inf"))
                    if failed or not finite:
                        bad.append((stack[k].numel(), name, k, failed, err))
            log["refreshes"].append({"cases_broken": len(bad),
                                     "worst_ortho_err": worst})
            if bad and log["saved"] is None:
                _, name, k, failed, err = min(bad)
                g = dict(zip(names, gl))[name].float()
                g = (g if projs[name].dim() == 3 else g[None])[k]
                p = (projs[name] if projs[name].dim() == 3
                     else projs[name][None])[k]
                np.savez_compressed(out_path, g=g.cpu().numpy(),
                                    proj=p.cpu().numpy(),
                                    rank=np.int64(psa.rank),
                                    oi_iters=np.int64(psa.oi_iters))
                log["saved"] = {"leaf": name, "group": k,
                                "refresh": len(log["refreshes"]) - 1,
                                "shape": list(g.shape),
                                "cholesky_failed": failed,
                                "ortho_err": err}
        return inner(grads, psa_state, psa, **kw)

    step_mod.psa_refresh = hooked
    out = train(targs, cfg)
    return {"train": out, **log}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=33)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "psa_refresh_breakdown.npz"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("refresh_breakdown_capture: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    import dataclasses

    import refresh_breakdown_capture as me
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.launch.mesh import spawn_ranks

    # train_lm_psa_compress.py --full-100m, without checkpoints
    cfg = dataclasses.replace(
        reduced_config(get_arch("qwen2-7b")), d_model=768, n_layers=12,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32_000,
        head_dim=None)
    targs = argparse.Namespace(
        arch="qwen2-7b", reduced=False, mesh="multipod", steps=args.steps,
        batch=8, seq=512, lr=1e-3, warmup=10, seed=0, data_seed=0, psa=True,
        psa_rank=16, ckpt_dir="", ckpt_every=20, keep_last=2, log_every=10,
        device="cuda", backend="gloo")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    res = spawn_ranks(me._rank, 2, backend="gloo", device="cuda",
                      args=(targs, cfg, os.path.abspath(args.out)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "steps": args.steps,
                      "train": res[0]["train"],
                      "refreshes": res[0]["refreshes"],
                      "saved": res[0]["saved"], "out": args.out}),
          flush=True)


if __name__ == "__main__":
    main()
