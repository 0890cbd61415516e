"""Final subspace errors of the JAX reference under stragglers and network
faults, at the configuration of chip_smoke.py's ``sdot_async``,
``sdot_faulty`` and ``fdot_faulty`` phases and of the async F-DOT of its
``resume`` phase (CPU, JAX).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_fault_errors.py

The data, graph, Q_init and ground truth are chip_smoke.py's: d = 1024,
r = 7, N = 20 nodes of erdos_renyi(20, 0.25, seed 1), 50,000 samples of
gaussian_eigengap_data(gap 0.7, seed 0), T_o = 100, t_c = 50, Q_init from
torch.Generator seed 0 (the port's ``orthonormal_init``), Q_true from a
float64 eigh of the summed node covariances. The fault model is
examples/net_faults.json's plan with its corruption in "nan" mode, seed 7.
The straggler is node 0, awake a duty of 1 ms / (1 ms + 10 ms) as in
benchmarks/async_straggler.py. Prints one JSON object: each run's final
error and, over its second half (steps 51-100), its largest and median
error; chip_smoke.py's limits for these phases come from it (~5 min, ~2
GB). It also writes the async S-DOT run's awake masks (replayed from the
reference's key splits, one a step) and its error trace to
tools/data/sdot_async_reference.npz, which chip_smoke.py injects on the
card to hold the port to the reference on the same masks.
"""
from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.async_gossip import AsyncConsensus
from repro.core.fdot import fdot
from repro.core.netfaults import FaultyConsensus, NetFaultModel
from repro.core.sdot import sdot
from repro.core.topology import erdos_renyi
from repro.data.pipeline import (gaussian_eigengap_data, partition_features,
                                 partition_samples)

D, R, N, SAMPLES, T_OUTER, T_C = 1024, 7, 20, 50_000, 100, 50
T_ROUND, DELAY = 0.001, 0.01
MODEL = NetFaultModel(p_drop=0.2, p_bad=0.05, p_good=0.5, p_corrupt=0.02,
                      corrupt_mode="nan", crash_windows=((0, 3, 3),))
FAULT_SEED = 7
DRAWS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                          "sdot_async_reference.npz")


def main() -> None:
    x, _, _ = gaussian_eigengap_data(D, SAMPLES, R, 0.7, seed=0)
    blocks = partition_samples(x, N)
    m = sum(np.asarray(b, np.float64) @ np.asarray(b, np.float64).T
            / b.shape[1] for b in blocks)
    q_true = jnp.asarray(np.linalg.eigh(m)[1][:, ::-1][:, :R].copy(),
                         jnp.float32)
    a = torch.randn((D, R), generator=torch.Generator().manual_seed(0))
    q_init = jnp.asarray(torch.linalg.qr(a)[0].numpy())
    graph = erdos_renyi(N, 0.25, seed=1)
    p_awake = np.ones(N)
    p_awake[0] = T_ROUND / (T_ROUND + DELAY)
    out = {}

    def final(label, fn):
        t0 = time.perf_counter()
        res = fn()
        tail = np.asarray(res.error_trace[T_OUTER // 2:])
        out[label] = {"final_err": float(res.error_trace[-1]),
                      "second_half_max": float(tail.max()),
                      "second_half_median": float(np.median(tail)),
                      "wall_s": time.perf_counter() - t0}
        return res

    common = dict(data=blocks, r=R, t_outer=T_OUTER, t_c=T_C, q_init=q_init,
                  q_true=q_true)
    final("sdot_sync", lambda: sdot(
        engine=FaultyConsensus(graph, NetFaultModel(), seed=FAULT_SEED),
        **common))
    res = final("sdot_async", lambda: sdot(
        engine=AsyncConsensus(graph, p_awake=p_awake, seed=0), **common))
    key, awake = jax.random.PRNGKey(0), []
    for _ in range(T_OUTER):              # sdot.py's async body: one split
        key, sub = jax.random.split(key)  # and one (t_max, N) draw a step
        awake.append(np.asarray(jax.random.bernoulli(
            sub, jnp.asarray(p_awake, jnp.float32), (T_C, N))))
    os.makedirs(os.path.dirname(DRAWS_PATH), exist_ok=True)
    np.savez_compressed(DRAWS_PATH, awake=np.packbits(np.stack(awake)),
                        shape=np.array([T_OUTER, T_C, N]),
                        error_trace=np.asarray(res.error_trace, np.float32))
    for debias in ("realized", "nominal"):
        final(f"sdot_faulty_{debias}", lambda: sdot(
            engine=FaultyConsensus(graph, MODEL, seed=FAULT_SEED,
                                   debias=debias), **common))
    slabs = partition_features(x, N)
    fcommon = dict(data_blocks=slabs, r=R, t_outer=T_OUTER, t_c=T_C,
                   t_c_qr=T_C, q_init=q_init, q_true=q_true)
    final("fdot_faulty", lambda: fdot(
        engine=FaultyConsensus(graph, MODEL, seed=FAULT_SEED), **fcommon))
    final("fdot_async", lambda: fdot(
        engine=AsyncConsensus(graph, p_awake=p_awake, seed=0), **fcommon))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
