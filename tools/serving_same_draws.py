"""The port's serving loop at chip_smoke.py's serving configuration on one
device, fed draws that do not depend on the device.

    PYTHONPATH=src python tools/serving_same_draws.py cuda   # on the card
    PYTHONPATH=src python tools/serving_same_draws.py cpu    # here
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/serving_same_draws.py \
        cpu --reference-draws                                # needs JAX

The configuration is tools/data/serving_reference.json's. By default the
stream's batches come from the port's stream on a CPU generator, moved to
the device, and the inits are the port's own (CPU generators too), so the
card and the CPU run the same inputs: their swap ticks, drift readings and
post-swap errors should agree to f32 rounding (the served bits need not).
``--reference-draws`` feeds the JAX reference's own stream and inits
instead (``ServiceDraws``), so the run can be held to the reference's
trajectory in that file. Prints one JSON object: swap ticks, max
staleness, the post-shift error after each swap and each drift read's
(tick, residual, triggered). Snapshots go to a temporary directory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.core.metrics import subspace_error
from repro_torch.data.pipeline import drifting_eigengap_stream
from repro_torch.serving.service import (PSAService, ServiceConfig,
                                         ServiceDraws, service_summary)

REF_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "serving_reference.json")


def reference_draws(cfg: ServiceConfig) -> ServiceDraws:
    import jax
    from repro.core.linalg import orthonormal_init
    from repro.data.pipeline import drifting_eigengap_stream as jstream
    jfn = jstream(cfg.d, cfg.r, cfg.gap, cfg.shift_at, seed=cfg.stream_seed,
                  lead=cfg.lead, shift_lead=cfg.shift_lead)[0]

    def init(seed, r):
        return np.asarray(orthonormal_init(jax.random.PRNGKey(seed), cfg.d,
                                           r))

    return ServiceDraws(
        batch_fn=lambda t, m: np.asarray(jfn(t, m)),
        served_q0=init(cfg.seed, cfg.r), ritz_init=init(cfg.seed, cfg.r + 1),
        cold_qinit=lambda rid: init(cfg.seed * 7 + 100 + rid, cfg.r))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("device")
    ap.add_argument("--reference-draws", action="store_true")
    args = ap.parse_args(argv)
    os.environ.setdefault("REPRO_OBS", "0")
    dev = torch.device(args.device)
    with open(REF_PATH) as f:
        cfg = ServiceConfig(**json.load(f)["config"])
    if args.reference_draws:
        draws = reference_draws(cfg)
    else:
        cpu_fn = drifting_eigengap_stream(
            cfg.d, cfg.r, cfg.gap, cfg.shift_at, seed=cfg.stream_seed,
            lead=cfg.lead, shift_lead=cfg.shift_lead, device="cpu")[0]
        draws = ServiceDraws(batch_fn=lambda t, m: cpu_fn(t, m).to(dev))
    with tempfile.TemporaryDirectory(prefix="serving_same_draws_") as work:
        svc = PSAService(cfg, work, device=dev, draws=draws)
        reads, read = [], svc.detector.read

        def logged_read(*a, **kw):
            stats = read(*a, **kw)
            reads.append([svc.tick + 1, stats.residual, stats.triggered])
            return stats

        svc.detector.read = logged_read
        errs = []
        for tick in range(cfg.total_ticks):
            swaps = svc.swaps
            svc.run(until=tick + 1)
            if svc.swaps > swaps:
                errs.append(float(subspace_error(svc.q_post,
                                                 svc.served.device)))
        svc.finalize()
        doc = service_summary(work)
    json.dump({"device": str(dev), "reference_draws": args.reference_draws,
               "swap_ticks": doc["swap_ticks"],
               "max_staleness": doc["max_staleness"],
               "post_shift_err_after_swap": errs, "drift_reads": reads},
              sys.stdout)
    print()


if __name__ == "__main__":
    main()
