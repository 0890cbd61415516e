"""LM training with the paper's technique in the loop, in the PyTorch port;
the twin of examples/train_lm_psa_compress.py.

Trains a qwen2-family model with the training driver (checkpoint/restart,
async saves) and PSA-compressed cross-pod gradient reduction over 2 pod
ranks: each pod is one node of the paper's network, S-DOT keeps the shared
gradient subspace, and cross-pod traffic shrinks ~a/r.

The default flags train the reduced model for 60 steps; ``--full-100m
--steps 300`` trains the ~100M-parameter config (d_model 768, 12 layers,
12 / 4 heads, d_ff 2048, vocabulary 32,000) at 8 x 512 tokens a step.

    PYTHONPATH=src python -m repro_torch.train_lm_psa_compress --device cpu
    PYTHONPATH=src python -m repro_torch.train_lm_psa_compress \\
        --full-100m --steps 300                                # card
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional, Sequence

from .configs import get_arch, reduced_config
from .launch.train import train


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--full-100m", action="store_true",
                    help="~100M-param config (use on the card)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="steps between saves (the run also saves at its "
                    "end)")
    ap.add_argument("--device", default=None,
                    help="torch device of both pod ranks (default: CUDA)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    args_in = ap.parse_args(argv)

    ckpt = args_in.ckpt_dir or tempfile.mkdtemp(prefix="psa_train_")
    targs = argparse.Namespace(
        arch="qwen2-7b", reduced=True, mesh="multipod",
        steps=args_in.steps, batch=4, seq=64, lr=1e-3, warmup=10,
        seed=0, data_seed=0, psa=True, psa_rank=16,
        ckpt_dir=ckpt, ckpt_every=args_in.ckpt_every, keep_last=2, log_every=10,
        device=args_in.device, backend=args_in.backend)
    cfg = None
    if args_in.full_100m:
        # ~100M params: d_model=768, 12 layers, vocab 32k
        cfg = dataclasses.replace(
            reduced_config(get_arch("qwen2-7b")), d_model=768, n_layers=12,
            n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32_000,
            head_dim=None)
        targs.reduced = False
        targs.batch, targs.seq = 8, 512

    out = train(targs, cfg)
    print(f"\ntrain summary: {out}")
    if not out["last_loss"] < out["first_loss"]:
        raise RuntimeError(f"loss must decrease: {out}")
    print(f"checkpoints in {ckpt}: restart the same command to auto-resume")
    print("OK")
    return out


if __name__ == "__main__":
    main()
