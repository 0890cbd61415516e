"""Time text variants of the bf16 flash-attention kernel beside the kernel
itself, on the card, in one process.

    python3 tools/flash_variants.py [--variant NAME ...] [--against FILE ...]
                                    [--rounds 2]

Each variant is ``csrc/flash_attention.cu`` with a few lines replaced (see
``VARIANTS``): a piece of the work taken out, or a parameter changed, to see
what that piece costs. A variant whose lines are not in the source any more
is skipped with a note. ``--against FILE`` also times a whole other source
of the kernel (another revision, e.g. the parent commit's
``csrc/flash_attention.cu``), named by its file name. The sources are copied to
``build/flash_variants/`` with ``hopper.cuh`` and built there by nvcc in
parallel, with the flags of ``kernels/_build.py``; each library is loaded
on its own. All run at qwen2-7b's prefill shape (q 4 x 28 x 2048 x 128,
k/v 4 x 4 x 2048 x 128, bf16, causal) on the same inputs, in turns, for
``--rounds`` rounds: device time a launch as chip_smoke.py takes it (CUDA
events around 20 launches behind a spin of the card, median of 5), the
largest error and the relative RMS error against the plain version (a
variant that leaves work out is wrong on purpose), and the ptxas lines on
registers, spills and serialized wgmmas (C75xx). Prints one JSON line a
variant and round, then a summary with the card's name and power limit.
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
SHAPE = dict(b=4, hq=28, hkv=4, s=2048, hd=128)

_RESCALE = """#pragma unroll
      for (int j = 0; j < kO / 4; ++j) {
        o[4 * j + 2 * i] *= alpha;
        o[4 * j + 2 * i + 1] *= alpha;
      }
"""
VARIANTS = {
    "kernel": [],
    # P V with P in one bf16, as a kernel without the split would do it
    "no_p_lo": [("      wgmma_rs_tb<HDP>(o, p_lo[kk], v_desc);\n", "")],
    # S and the softmax alone
    "no_pv": [("      wgmma_rs_tb<HDP>(o, p_hi[kk], v_desc);\n"
               "      wgmma_rs_tb<HDP>(o, p_lo[kk], v_desc);\n", "")],
    "no_o_rescale": [(_RESCALE, "")],
    "no_masks": [("    if (edge) {\n", "    if (false) {\n")],
    "two_stages": [("constexpr int kTcStages = 3;",
                    "constexpr int kTcStages = 2;")],
}


def build(names, against, out: Path) -> dict:
    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    (out / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
    sources = {}
    skipped = {}
    for name in names:
        text = src
        missing = [a for a, _ in VARIANTS[name] if a not in text]
        if missing:
            skipped[name] = f"lines not in the source: {missing[0][:60]!r}"
            continue
        for a, b in VARIANTS[name]:
            text = text.replace(a, b)
        sources[name] = text
    for path in against:
        sources[Path(path).stem] = Path(path).read_text()
    procs = {}
    for name, text in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
               str(out / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = {"lib": out / f"lib{name}.so", "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "C75" in ln or ("wgmma_kernelILi128" in ln and "Compiling" in ln)
            or "spill" in ln or "registers" in ln][:6]}
    return built, skipped


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", choices=sorted(VARIANTS),
                    help="variants to time beside the kernel (default: all)")
    ap.add_argument("--against", action="append", default=[],
                    help="another source of the kernel to time beside it")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import nvidia_smi, time_ms
    from repro_torch.kernels import ref

    names = ["kernel", *[v for v in (args.variant or VARIANTS)
                         if v != "kernel"]]
    built, skipped = build(names, args.against,
                           ROOT / "build" / "flash_variants")
    for name, why in skipped.items():
        print(json.dumps({"variant": name, "skipped": why}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, hq, hkv, s, hd = (SHAPE[k] for k in ("b", "hq", "hkv", "s", "hd"))
    q, k, v = [torch.randn(shape, generator=gen, device=dev).bfloat16()
               for shape in ((b, hq, s, hd), (b, hkv, s, hd),
                             (b, hkv, s, hd))]
    out = torch.empty_like(q)
    want = ref.flash_attention_plain(q, k, v, causal=True, q_offset=0,
                                     kv_valid=s).float()
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    runs = {}
    for rnd in range(args.rounds):
        for name, info in built.items():
            lib = ctypes.CDLL(str(info["lib"]))
            lib.flash_attention_launch.argtypes = ([vp] * 4 + [i32] * 11
                                                   + [ctypes.c_float, i32, vp,
                                                      i32, i32])

            def launch():
                err = lib.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, hq, hkv, s, s, hd, 0, s, 1, 0, 0, hd ** -0.5, 1,
                    vp(torch.cuda.current_stream().cuda_stream), hq // hkv, 0)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            ms = time_ms(launch)
            launch()
            torch.cuda.synchronize()
            diff = (out.float() - want).abs()
            runs.setdefault(name, []).append(ms)
            print(json.dumps({
                "variant": name, "round": rnd, "ms": ms,
                "max_abs_err": float(diff.max()),
                "rel_rms": float(diff.square().sum().sqrt()
                                 / want.square().sum().sqrt()),
                "ptxas": info["ptxas"]}), flush=True)
    print(json.dumps({"shape": SHAPE, "card": nvidia_smi(),
                      "median_ms": {n: statistics.median(t)
                                    for n, t in runs.items()}}), flush=True)


if __name__ == "__main__":
    main()
