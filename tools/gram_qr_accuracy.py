"""The CholeskyQR Gram kernel and its plain version against a float64 Gram,
on the card.

    python3 tools/gram_qr_accuracy.py

For bf16 V at (B, d, r) = (1 | 3, 16384, 32 | 64 | 128), two tall f32
shapes and the PSA trainer's refresh shapes in f32 (the cluster route),
seeds 0 and 1: the largest error on the diagonal and off it, and
the mean signed error on the diagonal, of ``ops.gram_qr`` (the kernel) and
of ``ref.gram_qr_ref`` (the plain version: V promoted to f32, one batched
cuBLAS product), each against V^T V in float64, beside max |G|, and the
kernel's largest error relative to max |G|, with the route its plan
takes. One JSON line a case, then the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CASES = [((1, 16384, 128), "bfloat16"), ((3, 16384, 128), "bfloat16"),
         ((1, 16384, 64), "bfloat16"), ((3, 16384, 64), "bfloat16"),
         ((3, 16384, 32), "bfloat16"), ((3, 1024, 64), "bfloat16"),
         ((1, 16384, 128), "float32"), ((20, 1024, 7), "float32"),
         ((2, 3584, 64), "float32"), ((2, 18944, 64), "float32"),
         ((1, 3584, 64), "float32"), ((1, 4096, 64), "float32"),
         ((1, 6400, 64), "float32")]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("gram_qr_accuracy: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _launch, gram_qr, ops, ref

    dev = torch.device("cuda")
    for shape, dtype in CASES:
        batch, d, r = shape
        for seed in (0, 1):
            gen = torch.Generator(device=dev).manual_seed(seed * 1000 + d + r)
            v = torch.randn(shape, generator=gen, device=dev).to(
                getattr(torch, dtype))
            exact = v.double().mT @ v.double()
            eye = torch.eye(r, dtype=torch.bool, device=dev)

            def errors(g):
                e = g.double() - exact
                return {"diag_max": float(e[:, eye].abs().max()),
                        "off_max": float(e[:, ~eye].abs().max())
                        if r > 1 else 0.0,
                        "diag_mean_signed": float(e[:, eye].mean())}
            got = ops.gram_qr(v)
            print(json.dumps({
                "shape": list(shape), "dtype": dtype, "seed": seed,
                "route": gram_qr.plan(batch, d, r, dtype == "bfloat16",
                                      _launch.card(0)[0]).route,
                "max_abs_g": float(exact.abs().max()),
                "kernel_rel_max": float((got.double() - exact).abs().max()
                                        / exact.abs().max()),
                "kernel": errors(got),
                "plain": errors(ref.gram_qr_ref(v))}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()
