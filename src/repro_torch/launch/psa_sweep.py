"""Multi-process PSA sweep entry point: the twin of
``repro/launch/psa_sweep.py``.

Streams micro-batches into per-node covariance sketches
(``streaming/ingest.py``), then shards the Monte-Carlo seed grid over worker
processes (``streaming/launcher.py``) and merges one ``SweepResult``:

    PYTHONPATH=src python -m repro_torch.launch.psa_sweep \
        --d 64 --nodes 20 --r 5 --seeds 8 --workers 4 \
        --topology er --p 0.25 --t-outer 50 --schedule lin2 \
        --workdir /tmp/psa_sweep [--device cpu]

It runs on the card unless ``--device cpu`` is given. A killed launcher
rerun with the same ``--workdir`` resumes: published worker shards are
never recomputed. ``--resume`` checkpoints each worker's sweep state every
``--sweep-chunk`` outer iterations, so a killed worker resumes mid-grid
with the same bits; the summary reports the reused shards and how far
each restored state carried its worker.

Fleet knobs (``streaming/launcher.py``): ``--elastic`` (un-pinned workers
that lease, steal and resume shards; ``--shards`` sets the steal
granularity, ``--lease-ttl`` how soon a silent shard is stolen),
``--stall-timeout`` (kill a worker whose heartbeat goes quiet),
``--heartbeat-interval`` (the supervision poll period), ``--chaos-plan``
(a seeded ``FaultPlan`` injected into the workers) and ``--net-faults`` (the
gossip under a seeded network-fault document).
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--r", type=int, default=5)
    ap.add_argument("--nodes", type=int, default=20)
    ap.add_argument("--gap", type=float, default=0.7)
    ap.add_argument("--batches", type=int, default=50,
                    help="micro-batches to ingest")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="samples per micro-batch (default: 10 * nodes)")
    ap.add_argument("--topology", default="er",
                    choices=["er", "ring", "star", "complete"])
    ap.add_argument("--p", type=float, default=0.25, help="ER edge prob")
    ap.add_argument("--graph-seed", type=int, default=1)
    ap.add_argument("--schedule", default="const",
                    choices=["const", "lin_half", "lin1", "lin2", "lin5"])
    ap.add_argument("--t-outer", type=int, default=50)
    ap.add_argument("--t-c", type=int, default=50)
    ap.add_argument("--cap", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=4,
                    help="Monte-Carlo seed count")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--resume", action="store_true",
                    help="chunk-checkpoint each worker's sweep-RunState "
                         "into its ckpt dir and resume killed workers "
                         "mid-grid; report skipped grid points")
    ap.add_argument("--sweep-chunk", type=int, default=None,
                    help="outer iterations per sweep checkpoint chunk "
                         "(default: t_outer // 5, implies --resume)")
    ap.add_argument("--shards", type=int, default=None,
                    help="leasable seed shards (default: one per worker; "
                         "more shards = finer work stealing)")
    ap.add_argument("--elastic", action="store_true",
                    help="fleet mode: un-pinned workers lease/steal/resume "
                         "shards; workers may join or leave mid-sweep")
    ap.add_argument("--retries", type=int, default=1,
                    help="per-shard (pinned) / per-slot (elastic) retry "
                         "budget")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="shared wall-clock deadline for the whole launch")
    ap.add_argument("--stall-timeout", type=float, default=None,
                    help="kill a worker whose heartbeat is older than this "
                         "(default: 60s when chunked, 0 = off)")
    ap.add_argument("--heartbeat-interval", type=float, default=0.2,
                    help="supervision poll period in seconds")
    ap.add_argument("--lease-ttl", type=float, default=30.0,
                    help="elastic mode: seconds before a silent shard "
                         "lease becomes stealable")
    ap.add_argument("--chaos-plan", default=None,
                    help="path to a FaultPlan JSON to inject into workers "
                         "(fire-drill mode; see streaming/chaos.py)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: where the stream, the "
                         "workers and the merge run")
    ap.add_argument("--net-faults", default=None,
                    help="path to a net-fault JSON document (or inline "
                         "JSON): run the sweep's gossip under seeded link "
                         "drops / bursts / crash-rejoin / corruption with "
                         "realized-mixing debias (core/netfaults.py); "
                         "defaults from $REPRO_NET_FAULTS")
    args = ap.parse_args(argv)

    import numpy as np

    from .._device import resolve_device
    from ..core.linalg import eigh_topr
    from ..data.pipeline import eigengap_stream
    from ..streaming.ingest import StreamingIngestor
    from ..streaming.launcher import launch_sweep

    batch_size = args.batch_size or 10 * args.nodes
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    batch_fn, _, _ = eigengap_stream(args.d, args.r, args.gap, seed=0,
                                     device=dev)
    ingestor = StreamingIngestor(n_nodes=args.nodes, d=args.d,
                                 batch_fn=batch_fn, batch_size=batch_size,
                                 device=dev)
    ingestor.ingest(args.batches)
    covs = ingestor.cov_stack()
    _, q_true = eigh_topr(covs.sum(0), args.r)
    ingest_s = time.perf_counter() - t0

    topo = {"kind": args.topology, "n": args.nodes, "p": args.p,
            "seed": args.graph_seed}
    sched = {"kind": args.schedule, "t_max": args.t_c, "cap": args.cap}
    resume = args.resume or args.sweep_chunk is not None or args.elastic
    sweep_chunk = None
    if resume:
        sweep_chunk = args.sweep_chunk or max(1, args.t_outer // 5)
    t0 = time.perf_counter()
    sw = launch_sweep(covs=covs, cases=[{"topology": topo,
                                         "schedule": sched}],
                      r=args.r, t_outer=args.t_outer, t_c=args.t_c,
                      seeds=list(range(args.seeds)), q_true=q_true,
                      workdir=args.workdir, n_workers=args.workers,
                      n_shards=args.shards, sweep_chunk=sweep_chunk,
                      elastic=args.elastic, retries=args.retries,
                      timeout=args.timeout,
                      stall_timeout=args.stall_timeout,
                      poll_interval=args.heartbeat_interval,
                      lease_ttl=args.lease_ttl,
                      chaos_plan=args.chaos_plan,
                      net_faults=args.net_faults, device=dev)
    sweep_s = time.perf_counter() - t0

    summary = {
        "ingested_samples_per_node": float(ingestor.samples_per_node[0]),
        "ingest_s": round(ingest_s, 3),
        "sweep_s": round(sweep_s, 3),
        "workers": args.workers,
        "device": dev.type,
        "seeds": args.seeds,
        "final_err_mean": float(np.asarray(sw.mean_trace)[-1]),
        "p2p_per_node_k": round(sw.ledger.per_node_p2p(args.nodes) / 1e3, 2),
    }
    if resume:
        rep = sw.resume_report
        summary["resume"] = {
            "sweep_chunk": sweep_chunk,
            "skipped_grid_points": rep["skipped_grid_points"],
            "reused_shards": rep["reused_shards"],
            "worker_resumed_steps": rep["worker_resumed_steps"],
            "attempts": rep["attempts"],
        }
        if "load_errors" in rep:
            summary["resume"]["load_errors"] = rep["load_errors"]
        if args.elastic:
            summary["resume"]["stolen_shards"] = rep.get("stolen_shards")
            summary["resume"]["lease_owners"] = rep.get("lease_owners")
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
