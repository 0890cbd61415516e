"""Teacher-forced decode against prefill in bf16, the reference's and the
port's, on a recurrentgemma-2b of full depth and reduced width (CPU).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/rglru_decode_drift.py \
        [--arch recurrentgemma-2b] [--d-model 640] [--tokens 64]

26 layers (the config's own pattern), d_model 640 (10 heads of 64, one kv
head), d_ff 3 d_model, vocabulary 4,096, bf16; the reference's
``init_params`` (PRNGKey 0) carried across to the port; 2 x ``--tokens``
tokens drawn with numpy (seed 0). For each package: the relative RMS of
the teacher-forced ``decode_step`` logits from ``forward``'s over the same
tokens (chip_smoke.py's DECODE_TOL reading), and the two prefills' relative
RMS from each other. The reference's RG-LRU full path convolves and takes
its gates' products in bf16 where its decode works in f32; the port runs
both in f32. ``--arch qwen2-7b`` gives the attention-only yardstick at the
same size. Prints one JSON line.
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
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--d-model", type=int, default=640)
    ap.add_argument("--tokens", type=int, default=64)
    args = ap.parse_args()
    d, s = args.d_model, args.tokens
    kw = dict(d_model=d, n_heads=10, n_kv_heads=1, d_ff=3 * d,
              vocab_size=4096, head_dim=None, dtype="bfloat16")
    jc = dataclasses.replace(jcfg.get_arch(args.arch), **kw)
    tc = dataclasses.replace(tcfg.get_arch(args.arch), **kw)
    params = jax.jit(lambda k: jt.init_params(k, jc))(jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(0).integers(0, 4096, (2, s)).astype(np.int32)

    ref_prefill = np.asarray(jax.jit(lambda p, t: jt.forward(
        p, {"tokens": t}, jc, remat=False))(params, toks), np.float32)
    step = jax.jit(lambda p, st, t: jt.decode_step(p, st, t, jc))
    state = jt.init_decode_state(jc, 2, s)
    ref_decode = []
    for t in range(s):
        lg, state = step(params, state, toks[:, t:t + 1])
        ref_decode.append(np.asarray(lg, np.float32))

    with torch.inference_mode():
        port_prefill = tt.forward(tparams, {"tokens": torch.from_numpy(toks)},
                                  tc).float().numpy()
        tstate = tt.init_decode_state(tc, 2, s, device="cpu")
        port_decode = []
        for t in range(s):
            lg, tstate = tt.decode_step(tparams, tstate,
                                        torch.from_numpy(toks[:, t:t + 1]),
                                        tc)
            port_decode.append(lg.float().numpy())

    print(json.dumps({
        "arch": args.arch, "layers": jc.n_layers, "d_model": d, "tokens": s,
        "dtype": "bfloat16",
        "reference_decode_vs_prefill": rel_rms(np.concatenate(ref_decode, 1),
                                               ref_prefill),
        "port_decode_vs_prefill": rel_rms(np.concatenate(port_decode, 1),
                                          port_prefill),
        "port_prefill_vs_reference_prefill": rel_rms(port_prefill,
                                                     ref_prefill)}))


if __name__ == "__main__":
    main()
