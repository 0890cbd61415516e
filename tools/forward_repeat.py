"""Repeat the f32 forward of tests/test_torch_gpu.py's
``test_forward_on_card_matches_cpu`` on the card, against the CPU once.

    python3 tools/forward_repeat.py [--runs 300] [--threshold 1e-5]

Reduced qwen2-7b (f32, 3 layers, 2 x 256 tokens of make_lm_batch, weights
from torch.Generator seed 0), the test's own setup. The CPU forward runs
once; the card's forward runs ``--runs`` times, layer by layer (the same ops
as ``forward``): each run's largest |logits difference| from the CPU, the
test's own criterion (|diff| <= 1e-4 + 1e-4 |cpu|) and whether its logits
equal run 0's bit for bit. For any run above ``--threshold`` it dumps the
largest difference of each layer's output from the CPU's and from run 0's
on the card, to find the first op that diverges. Prints one JSON summary:
the distribution of the readings and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def layer_outputs(params, tokens, cfg, transformer):
    """[embedding, block 0, ..., block L-1, logits], as ``forward`` makes
    them."""
    outs = [transformer.embed_inputs(params, {"tokens": tokens}, cfg)]
    pattern = cfg.pattern_for_layers()
    for g in range(cfg.n_groups):
        gp = transformer._group(params["groups"], g)
        for i, kind in enumerate(pattern):
            outs.append(transformer._apply_block_full(
                gp[f"blk{i}_{kind}"], outs[-1], cfg, kind, True))
    outs.append(transformer._head(params, outs[-1], cfg))
    return outs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=300)
    ap.add_argument("--threshold", type=float, default=1e-5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("forward_repeat: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models import transformer

    dev = torch.device("cuda")
    cfg = reduced_config(get_arch("qwen2-7b"), n_layers=3)
    cpu_params = transformer.init_params(torch.Generator().manual_seed(0),
                                         cfg, device="cpu")
    cpu_toks = make_lm_batch(cfg, 0, 0, 2, 256, device="cpu")["tokens"]
    params = transformer.tree_map(lambda t: t.to(dev), cpu_params)
    toks = cpu_toks.to(dev)
    with torch.inference_mode():
        want = layer_outputs(cpu_params, cpu_toks, cfg, transformer)
        first, readings, fails, same, dumps = None, [], 0, 0, []
        for run in range(args.runs):
            outs = layer_outputs(params, toks, cfg, transformer)
            got = outs[-1].cpu()
            diff = (got - want[-1]).abs()
            reading = float(diff.max())
            readings.append(reading)
            fails += bool((diff > 1e-4 + 1e-4 * want[-1].abs()).any())
            if first is None:
                first = [o.clone() for o in outs]
            same += bool(torch.equal(outs[-1], first[-1]))
            if reading > args.threshold and len(dumps) < 5:
                dumps.append({
                    "run": run, "max_abs_diff": reading,
                    "layers_vs_cpu": [float((o.cpu() - w).abs().max())
                                      for o, w in zip(outs, want)],
                    "layers_vs_run_0": [float((o - f).abs().max())
                                        for o, f in zip(outs, first)]})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    q = statistics.quantiles(readings, n=100) if len(readings) > 1 else [0.0]
    print(json.dumps({
        "card": card, "runs": args.runs, "threshold": args.threshold,
        "max_abs_diff": {"min": min(readings), "median":
                         statistics.median(readings), "p99": q[-1],
                         "max": max(readings)},
        "above_threshold": sum(x > args.threshold for x in readings),
        "failing_the_test_limit": fails,
        "logits_equal_to_run_0": same,
        "layer_names": ["embed", *[f"block{i}" for i in
                                   range(len(want) - 2)], "logits"],
        "dumps": dumps}), flush=True)


if __name__ == "__main__":
    main()
