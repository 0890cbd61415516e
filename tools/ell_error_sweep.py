"""Read the ELL gossip kernel's error margin over many seeded payloads.

    python3 tools/ell_error_sweep.py [--seeds 200] [--out PATH]

On the card, for each seed s in 0..seeds-1, z is drawn from
``torch.Generator("cuda").manual_seed(s)``, the kernel's round is held
against the same round summed in float64 (the slots scattered to a dense
matrix, on the same bf16-quantised messages where the route quantises),
and the reading is the error relative to the limit the card tests and
chip_smoke.py use: max |out - want| / (ELL_TOL * max |want| + 1e-7), with
ELL_TOL = 1e-6. A reading above 1 is a kernel fault. Routes and shapes:

* ``row3_f32`` / ``row3_bf16``: watts_strogatz(4096, 6, 0.1, seed 1) at
  K = 3920, the single-matrix kernel (row 3's shape);
* ``batched_f32`` / ``batched_bf16``: the four graphs of seeds 1-4
  stacked, K = 980 (bdot_sparse's row stage), one batched launch;
* ``staging_f32`` / ``staging_bf16``: erdos_renyi(1024, 0.55, seed 1) at
  K = 256 under a window of 8 rows (slots staged in shared memory) and of
  32 (slots read from device memory), the graph of the card test
  ``test_ell_bits_do_not_depend_on_slot_staging``.

Prints one JSON object (and writes it to ``--out``, default
chiprun_out/ell_error_sweep.json): each case's worst reading, its seed, and
the median; the last line names the worst reading of all. Exits 1 if any
reading is above 1. Needs an NVIDIA H100 with nvcc; exits 2 without a
card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

ELL_TOL = 1e-6


def _dense_f64(sw):
    """A ((B,) N, N) float64 matrix of a SparseW's off-diagonal slots
    (padded slots add 0 on the diagonal)."""
    idx, val = sw.ell_idx, sw.ell_val
    lead = tuple(sw.diag.shape[:-1])
    n = sw.n
    rows = torch.arange(n, device=idx.device)[:, None].expand(*idx.shape)
    w = torch.zeros(lead + (n, n), dtype=torch.float64, device=idx.device)
    index = (rows, idx.long())
    if lead:
        index = (torch.arange(lead[0], device=idx.device)[:, None, None]
                 .expand(*idx.shape),) + index
    w.index_put_(index, val.double(), accumulate=True)
    return w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=200)
    ap.add_argument("--out", default="chiprun_out/ell_error_sweep.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ell_error_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.core import topology
    from repro_torch.core.sparse import SparseW
    from repro_torch.kernels import ell_spmm, ops

    dev = torch.device("cuda")
    ws = [SparseW.from_graph(topology.watts_strogatz(4096, k=6, p=0.1,
                                                     seed=s), device=dev)
          for s in (1, 2, 3, 4)]
    st = SparseW.stack(ws)
    er = SparseW.from_graph(topology.erdos_renyi(1024, 0.55, seed=1),
                            device=dev)
    cases = {}
    for quantise in (False, True):
        tag = "bf16" if quantise else "f32"
        cases[f"row3_{tag}"] = (ws[0], (4096, 3920), [ws[0].window])
        cases[f"batched_{tag}"] = (st, (4, 4096, 980), [st.window])
        cases[f"staging_{tag}"] = (er, (1024, 256), [
            ell_spmm.WindowPlan(8, 0, 0, 1), ell_spmm.WindowPlan(32, 0, 0, 1)])
    report = {"card": torch.cuda.get_device_name(0), "seeds": args.seeds,
              "tolerance": ELL_TOL, "cases": {}}
    for name, (sw, shape, windows) in cases.items():
        quantise = name.endswith("bf16")
        w_off, diag = _dense_f64(sw), sw.diag.double()[..., None]
        readings = []
        for seed in range(args.seeds):
            gen = torch.Generator(device=dev).manual_seed(seed)
            z = torch.randn(shape, generator=gen, device=dev)
            z_src = z.to(torch.bfloat16) if quantise else z
            want = diag * z.double() + w_off @ z_src.double()
            limit = ELL_TOL * float(want.abs().max()) + 1e-7
            worst = 0.0
            for w in windows:
                got = ops.ell_spmm(sw.ell_idx, sw.ell_val, sw.diag, z,
                                   payload_dtype="bfloat16" if quantise
                                   else None, window=w)
                worst = max(worst, float((got.double() - want).abs().max()))
            readings.append(worst / limit)
        top = max(range(len(readings)), key=readings.__getitem__)
        report["cases"][name] = {
            "shape": list(shape), "ell_width": sw.ell_width,
            "windows": [[w.band_rows, w.halo] for w in windows],
            "worst_reading": readings[top], "worst_seed": top,
            "median_reading": statistics.median(readings),
            "over_limit": sum(x > 1.0 for x in readings)}
    worst_case = max(report["cases"],
                     key=lambda c: report["cases"][c]["worst_reading"])
    report["worst"] = {"case": worst_case,
                       **report["cases"][worst_case]}
    text = json.dumps(report, indent=1)
    print(text)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text + "\n")
    print(json.dumps({"worst_reading": report["worst"]["worst_reading"],
                      "case": worst_case}))
    return 1 if report["worst"]["worst_reading"] > 1.0 else 0


if __name__ == "__main__":
    sys.exit(main())
