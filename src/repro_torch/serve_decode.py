"""Batched serving demo: a streamed prompt, then greedy token-by-token
decode with KV / recurrent-state caches, on two architectures (one
attention, one sub-quadratic hybrid) at reduced size; the twin of
examples/serve_decode.py.

    PYTHONPATH=src python -m repro_torch.serve_decode            # on the card
    PYTHONPATH=src python -m repro_torch.serve_decode --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from ._device import resolve_device
from .configs import get_arch, reduced_config
from .data.pipeline import make_lm_batch
from .models.transformer import decode_step, init_decode_state, init_params

BATCH, PROMPT, GEN = 4, 16, 24


def serve(aid: str, dev: torch.device) -> torch.Tensor:
    cfg = reduced_config(get_arch(aid))
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    toks = make_lm_batch(cfg, 0, 0, BATCH, PROMPT + GEN,
                         device=dev)["tokens"]
    prompt = toks[:, :PROMPT]

    with torch.inference_mode():
        state = init_decode_state(cfg, BATCH, PROMPT + GEN, device=dev)
        t0 = time.perf_counter()
        # prefill by streaming the prompt (cache warm-up)
        for t in range(PROMPT):
            logits, state = decode_step(params, state, prompt[:, t:t + 1],
                                        cfg)
        # greedy generation
        outs = [logits.argmax(-1).to(torch.int32)]
        for _ in range(GEN - 1):
            logits, state = decode_step(params, state, outs[-1], cfg)
            outs.append(logits.argmax(-1).to(torch.int32))
        finite = bool(torch.isfinite(logits).all())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    gen = torch.cat(outs, dim=1)
    if not finite:
        raise RuntimeError(f"{aid}: non-finite logits")
    print(f"{aid:24s} generated {tuple(gen.shape)} tokens in {dt:.1f}s "
          f"({BATCH * GEN / dt:.1f} tok/s on {dev.type})")
    return gen


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    dev = resolve_device(ap.parse_args(argv).device)
    gens = {aid: serve(aid, dev)
            for aid in ("qwen2-7b",              # GQA attention + KV cache
                        "recurrentgemma-2b")}    # RG-LRU + SWA hybrid
    print("OK")
    return gens


if __name__ == "__main__":
    main()
