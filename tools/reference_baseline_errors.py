"""The JAX reference's baselines at the configuration of chip_smoke.py's
``baselines`` phase (CPU, JAX).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_baseline_errors.py

The data and graph are chip_smoke.py's sdot_dense: d = 1024, r = 7, N = 20
nodes of erdos_renyi(20, 0.25, seed 1), 50,000 samples of
gaussian_eigengap_data(gap 0.7, seed 0), covs M_i = X_i X_i^T / n_i, Q_true
from a float64 eigh of their sum. The budgets are
benchmarks/fig45_baselines.py's at T_o = 100: SeqPM on sum M_i and
SeqDistPM with iters_per_vec = 100 // 7 (t_c = 50), DSA and DPGD with
T_o = 500 and lr 0.05, DeEPCA with T_o = 100 and t_mix 3, and d-PM on
fdot_dense's 20 feature slabs with iters_per_vec 14 and t_c 50. Every
method runs fused (the reference's default) from seed 0, so all six start
from the same init, orthonormal_init(PRNGKey(0), 1024, 7).

Writes tools/data/baselines_reference.npz: ``q_init`` (1024, 7) f32, the
init every method starts from, and ``trace_<method>`` (float64), each
method's error trace. Prints one JSON object: each method's final error
and wall (~3 min on the CPU, ~2 GB). chip_smoke.py runs the port on the
card from ``q_init`` and holds it to these traces.
"""
from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.baselines import d_pm, deepca, dpgd, dsa, seq_dist_pm, seq_pm
from repro.core.consensus import DenseConsensus
from repro.core.linalg import orthonormal_init
from repro.core.topology import erdos_renyi
from repro.data.pipeline import (gaussian_eigengap_data, partition_features,
                                 partition_samples)

D, R, N, SAMPLES = 1024, 7, 20, 50_000
IPV, T_C, T_LONG, LR, T_DEEPCA, T_MIX = 100 // 7, 50, 500, 0.05, 100, 3
OUT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "baselines_reference.npz")


def main() -> None:
    x, _, _ = gaussian_eigengap_data(D, SAMPLES, R, 0.7, seed=0)
    blocks = partition_samples(x, N)
    covs = jnp.stack([b @ b.T / b.shape[1] for b in blocks])
    m64 = sum(np.asarray(b, np.float64) @ np.asarray(b, np.float64).T
              / b.shape[1] for b in blocks)
    q_true = jnp.asarray(np.linalg.eigh(m64)[1][:, ::-1][:, :R].copy(),
                         jnp.float32)
    engine = DenseConsensus(erdos_renyi(N, 0.25, seed=1))
    slabs = partition_features(x, N)
    runs = {
        "seq_pm": lambda: seq_pm(covs.sum(0), R, IPV, q_true=q_true),
        "seq_dist_pm": lambda: seq_dist_pm(covs, engine, R, IPV, t_c=T_C,
                                           q_true=q_true),
        "dsa": lambda: dsa(covs, engine, R, T_LONG, lr=LR, q_true=q_true),
        "dpgd": lambda: dpgd(covs, engine, R, T_LONG, lr=LR, q_true=q_true),
        "deepca": lambda: deepca(covs, engine, R, T_DEEPCA, t_mix=T_MIX,
                                 q_true=q_true),
        "d_pm": lambda: d_pm(slabs, engine, R, IPV, t_c=T_C, q_true=q_true),
    }
    arrays = {"q_init": np.asarray(
        orthonormal_init(jax.random.PRNGKey(0), D, R), np.float32)}
    out = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        _, errs = run()
        errs = np.asarray(errs, np.float64)
        arrays[f"trace_{name}"] = errs
        out[name] = {"final_err": float(errs[-1]), "steps": len(errs),
                     "wall_s": time.perf_counter() - t0}
    np.savez_compressed(OUT_PATH, **arrays)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
