"""The int8 KV cache's gap from the bf16 cache in teacher-forced decode,
the reference's and the port's, on a qwen2-7b of full depth and reduced
width (CPU): the yardstick of chip_smoke.py's KV_QUANT_TOL.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/kv_quant_gap.py \
        [--d-model 512] [--steps 5] [--batch 4]

28 layers (the config's own), d_model 512 (4 query heads of 128, qwen2's
head dim, over 2 kv heads: a GQA group), d_ff 3 d_model, vocabulary 4,096,
bf16; the reference's ``init_params`` (PRNGKey 0) carried across to the
port; ``--batch`` x ``--steps`` tokens drawn with numpy (seed 0). For each
package: ``--steps`` teacher-forced ``decode_step``s from a fresh state
with ``kv_quant`` on and off, and the relative RMS of the int8 run's logits
from the bf16 run's (chip_smoke.py's ``compare``). Prints one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import numpy as np
import torch

from repro import configs as jcfg
from repro.models import transformer as jt
from repro_torch import configs as tcfg
from repro_torch.interop import params_from_reference
from repro_torch.models import transformer as tt


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.sqrt(np.square(got - want).sum() / np.square(want).sum()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    d, steps, b = args.d_model, args.steps, args.batch
    kw = dict(d_model=d, n_heads=d // 128, n_kv_heads=d // 256, d_ff=3 * d,
              vocab_size=4096, dtype="bfloat16")
    jcs = {q: dataclasses.replace(jcfg.get_arch("qwen2-7b"), kv_quant=q, **kw)
           for q in (False, True)}
    tcs = {q: dataclasses.replace(tcfg.get_arch("qwen2-7b"), kv_quant=q, **kw)
           for q in (False, True)}
    params = jax.jit(lambda k: jt.init_params(k, jcs[False]))(
        jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(0).integers(0, 4096, (b, steps)).astype(
        np.int32)
    ref, port = {}, {}
    for q in (False, True):
        jc, tc = jcs[q], tcs[q]
        step = jax.jit(lambda p, st, t, jc=jc: jt.decode_step(p, st, t, jc))
        state = jt.init_decode_state(jc, b, steps)
        out = []
        for t in range(steps):
            lg, state = step(params, state, toks[:, t:t + 1])
            out.append(np.asarray(lg, np.float32))
        ref[q] = np.concatenate(out, 1)
        with torch.inference_mode():
            tstate = tt.init_decode_state(tc, b, steps, device="cpu")
            out = []
            for t in range(steps):
                lg, tstate = tt.decode_step(
                    tparams, tstate, torch.from_numpy(toks[:, t:t + 1]), tc)
                out.append(lg.float().numpy())
        port[q] = np.concatenate(out, 1)
    print(json.dumps({
        "arch": "qwen2-7b", "layers": jcs[True].n_layers, "d_model": d,
        "heads": kw["n_heads"], "kv_heads": kw["n_kv_heads"], "batch": b,
        "steps": steps, "dtype": "bfloat16",
        "reference_int8_vs_bf16": rel_rms(ref[True], ref[False]),
        "port_int8_vs_bf16": rel_rms(port[True], port[False]),
        "port_int8_vs_reference_int8": rel_rms(port[True], ref[True]),
        "port_bf16_vs_reference_bf16": rel_rms(port[False], ref[False])}))


if __name__ == "__main__":
    main()
