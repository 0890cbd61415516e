"""The JAX reference's serving loop at the configuration of chip_smoke.py's
``serving`` phase (CPU, JAX).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_service_trajectory.py

The configuration is the paper's CIFAR-10 row as the PSA phases use it:
d = 1024, r = 7, N = 20 nodes of erdos_renyi(20, 0.25, seed 1), T_o = 100,
t_c = 50, a drifting eigengap stream (gap 0.7, lead 3.0, shift_lead 6.0,
shift_at 8) read 2,000 samples a tick (100 a node) for 26 ticks, the
re-solve advanced 2 chunks of 10 steps a tick, every other field at the
``ServiceConfig`` default. It runs ``repro.serving.service.PSAService`` on
its own stream, fault-free, to the end, and then the warm-start experiment
of tests/test_serving.py at that width: the covs of the stream's first 8
batches (pre-shift) and of its first 10 (2 post-shift batches), an
incumbent solved on the pre-shift covs (T_o = 20 from
orthonormal_init(PRNGKey(3))), and the iterations a cold start
(PRNGKey(4)) and a warm start from the incumbent take to reach 1e-3
against the post-shift covs' top 7 (T_o = 100).

Writes tools/data/serving_reference.json: the configuration, the swap and
reject ticks, max staleness, the query counts, the served subspace's
error against the post-shift population's top 7 at the end and after each
swap (``post_shift_err_after_swap``: the k-th entry is the subspace served
after k + 1 swaps), each drift read's (tick, residual, triggered), and the
warm and cold iteration counts with the incumbent's starting error (~30 s
on the CPU, ~2 GB, snapshots in a temporary directory). chip_smoke.py reads
the file (and no JAX) to hold the port to this trajectory; none of it is a
time or a rate.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.linalg import eigh_topr, orthonormal_init
from repro.core.metrics import subspace_error
from repro.core.runtime import run_monolithic
from repro.core.sdot import sdot_program
from repro.data.pipeline import drifting_eigengap_stream
from repro.serving.service import PSAService, ServiceConfig, service_summary
from repro.streaming.ingest import StreamingIngestor
from repro.streaming.launcher import build_engine

CONFIG = dict(d=1024, r=7, n_nodes=20, batch_size=2000, gap=0.7, lead=3.0,
              shift_lead=6.0, shift_at=8, total_ticks=26, t_outer=100,
              t_c=50, resolve_chunk=10, chunks_per_tick=2,
              topology={"kind": "er", "n": 20, "p": 0.25, "seed": 1})
WARM_PRE, WARM_POST, T_INCUMBENT, T_LONG, TARGET = 8, 2, 20, 100, 1e-3
OUT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "serving_reference.json")


def iterations_to(trace: np.ndarray, target: float):
    """1-based iteration at which ``trace`` first drops below ``target``
    (None if it never does)."""
    below = np.flatnonzero(np.asarray(trace) < target)
    return int(below[0]) + 1 if below.size else None


def warm_start(cfg: ServiceConfig) -> dict:
    batch_fn, _, _ = drifting_eigengap_stream(
        cfg.d, cfg.r, cfg.gap, cfg.shift_at, seed=cfg.stream_seed,
        lead=cfg.lead, shift_lead=cfg.shift_lead)
    ing = StreamingIngestor(n_nodes=cfg.n_nodes, d=cfg.d, batch_fn=batch_fn,
                            batch_size=cfg.batch_size)
    ing.ingest(WARM_PRE)
    covs_pre = ing.cov_stack()
    ing.ingest(WARM_POST)
    covs_post = ing.cov_stack()
    engine = build_engine(cfg.topology)
    _, q_true = eigh_topr(covs_post.sum(0), cfg.r)

    def prog(covs, q_init, t_outer, q_true=None):
        return sdot_program(covs=covs, engine=engine, r=cfg.r,
                            t_outer=t_outer, t_c=cfg.t_c, q_init=q_init,
                            q_true=q_true)

    incumbent = run_monolithic(prog(
        covs_pre, orthonormal_init(jax.random.PRNGKey(3), cfg.d, cfg.r),
        T_INCUMBENT)).q_nodes.mean(axis=0)
    cold = run_monolithic(prog(
        covs_post, orthonormal_init(jax.random.PRNGKey(4), cfg.d, cfg.r),
        T_LONG, q_true)).error_trace
    warm = run_monolithic(prog(covs_post, incumbent, T_LONG,
                               q_true)).error_trace
    return {"pre_batches": WARM_PRE, "post_batches": WARM_POST,
            "incumbent_t_outer": T_INCUMBENT, "t_outer": T_LONG,
            "target": TARGET,
            "incumbent_err": float(subspace_error(q_true, incumbent)),
            "iterations_cold": iterations_to(cold, TARGET),
            "iterations_warm": iterations_to(warm, TARGET),
            "final_err_cold": float(cold[-1]),
            "final_err_warm": float(warm[-1])}


def main() -> None:
    cfg = ServiceConfig(**CONFIG)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="serving_reference_") as work:
        os.environ.setdefault("REPRO_OBS", "0")
        svc = PSAService(cfg, work)
        drift, read = [], svc.detector.read

        def logged_read(*args, **kwargs):
            stats = read(*args, **kwargs)
            drift.append([svc.tick + 1, stats.residual, stats.triggered])
            return stats

        svc.detector.read = logged_read
        swap_errs = []
        for tick in range(cfg.total_ticks):
            swaps = svc.swaps
            svc.run(until=tick + 1)
            if svc.swaps > swaps:
                swap_errs.append(float(subspace_error(
                    svc.q_post, jnp.asarray(svc.served_q))))
        svc.finalize()
        doc = service_summary(work)
        post_err = float(subspace_error(svc.q_post,
                                        jnp.asarray(svc.served_q)))
    serve_s = time.perf_counter() - t0
    out = {
        "what": "JAX reference on the CPU, its own jax.random stream: "
                "trajectory and errors only, no time",
        "config": dataclasses.asdict(cfg),
        "swaps": doc["swaps"], "swap_ticks": doc["swap_ticks"],
        "gate_rejects": doc["gate_rejects"],
        "reject_ticks": doc["reject_ticks"],
        "max_staleness": doc["max_staleness"],
        "queries": {k: doc["queries"][k] for k in ("submitted", "answered",
                                                   "shed", "expired")},
        "post_shift_err": post_err,
        "post_shift_err_after_swap": swap_errs,
        "drift_reads": drift,
        "warm_start": warm_start(cfg),
    }
    os.makedirs(os.path.dirname(OUT_PATH), exist_ok=True)
    with open(OUT_PATH, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({**out, "seconds": time.perf_counter() - t0,
                      "service_seconds": serve_s}))


if __name__ == "__main__":
    main()
