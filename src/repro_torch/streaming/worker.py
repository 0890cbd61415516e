"""Sweep worker: one shard of a sharded Monte-Carlo sweep, the twin of
``repro/streaming/worker.py``.

    python -m repro_torch.streaming.worker <workdir>/spec.json <shard>
    python -m repro_torch.streaming.worker <workdir>/spec.json --fleet \\
        --worker w0 [--ttl 30]

Both forms take ``--device`` and run on the card unless it says ``cpu``;
with no card a worker raises. ``streaming/launcher.py`` spawns them; they
also run by hand. The pinned form runs one shard. The ``--fleet`` form runs
the elastic loop (``streaming/fleet.py``): take a shard's lease, run it
from whatever sweep checkpoint its previous owner left, publish, release,
take the next, and exit once every shard has a published result.

A worker rebuilds its engines and schedules from the spec (graph
constructions are seed-deterministic), loads the cov stacks or raw data
blocks from ``problem.npz``, runs ``sdot_sweep`` (``netfault_sweep`` under
a net-fault document) over its shard's seeds, and publishes ``{q,
error_traces, seeds, ledger, resumed_steps, spec_fp, port_device}``
atomically into ``<workdir>/worker_<shard>/result``. A valid published
result makes it exit at once, after removing any checkpoint a crash left
beside it: the published result always wins.

Robustness wiring (no-ops outside a supervised launch):

* a heartbeat file ``worker_<shard>/heartbeat`` is touched at every chunk
  boundary (``CheckpointManager.on_save``) and before the publish;
* chaos hooks come from ``REPRO_CHAOS_PLAN`` (``chaos.hooks_from_env``),
  and a ``drop`` fault fires after the publish;
* under a lease, every chunk boundary renews it, and a foreign fencing
  token abandons the shard (``LeaseLost``).

With ``spec["sweep_chunk"]`` the shard runs through the runtime's chunked
driver, checkpointing the sweep state into ``worker_<shard>/ckpt`` every
``sweep_chunk`` outer iterations, so a killed worker, or one that steals
the shard, resumes mid-grid with the bits of the uninterrupted sweep.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys


def run_shard(spec: dict, workdir: str, shard: int, *, worker=None,
              lease_store=None, lease=None, device=None) -> int:
    """Compute and publish one shard (idempotent; resumes from checkpoints)
    on ``device`` (the card unless the caller asks for the CPU).

    ``worker`` is the process identity for chaos targeting and lease
    ownership (default: the shard index); ``lease_store`` / ``lease`` renew
    the lease at every chunk boundary in fleet mode."""
    from repro_torch._device import resolve_device
    from repro_torch.obs import get_journal
    from repro_torch.streaming.launcher import _load_result, _worker_dir

    dev = resolve_device(device)
    shard = int(shard)
    shard_dir = _worker_dir(workdir, shard)
    worker_id = str(worker) if worker is not None else str(shard)
    if _load_result(workdir, spec, shard, device=dev) is not None:
        shutil.rmtree(os.path.join(shard_dir, "ckpt"), ignore_errors=True)
        get_journal().event("shard_skip", "worker", shard=shard)
        print(f"worker {shard}: result already published, nothing to do")
        return 0
    shutil.rmtree(os.path.join(shard_dir, "result"), ignore_errors=True)
    # the whole shard is one span: a kill leaves it open in the journal,
    # which is how forensics names the work a dead worker was doing
    sp = get_journal().begin("shard_run", "worker", shard=shard,
                             worker=worker_id)
    try:
        return _run_shard_body(spec, workdir, shard, worker_id, sp,
                               lease_store, lease, dev)
    except BaseException:
        sp.end(ok=False)
        raise


def _problem(spec: dict, workdir: str, dev):
    """(operand kwargs for the sweep, q_true) from ``problem.npz``."""
    import numpy as np
    import torch

    problem = np.load(os.path.join(workdir, "problem.npz"))

    def load(key):
        return torch.from_numpy(problem[key]).to(dev)

    if spec.get("operand") == "data":
        operand = {"data": [load(f"data_{i}")
                            for i in range(spec["n_blocks"])]}
    elif spec["ragged"]:
        operand = {"covs": [load(f"covs_{ci}")
                            for ci in range(spec["n_cov_stacks"])]}
    else:
        operand = {"covs": load("covs")}
    return operand, (load("q_true") if spec["has_q_true"] else None)


def _run_shard_body(spec, workdir, shard, worker_id, sp, lease_store, lease,
                    dev) -> int:
    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager, save_tree
    from repro_torch.core.sweep import netfault_sweep, sdot_sweep
    from repro_torch.obs import get_journal
    from repro_torch.streaming import chaos
    from repro_torch.streaming.fleet import touch_heartbeat
    from repro_torch.streaming.launcher import (DEVICE_CODES, _worker_dir,
                                                build_engine, build_schedule,
                                                spec_fingerprint)

    shard_dir = _worker_dir(workdir, shard)
    out_dir = os.path.join(shard_dir, "result")
    ckpt_dir = os.path.join(shard_dir, "ckpt")
    hb_path = os.path.join(shard_dir, "heartbeat")

    seeds = spec["shards"][shard]
    if not seeds:
        raise ValueError(f"worker {shard} got an empty seed shard")
    operand, q_true = _problem(spec, workdir, dev)
    engines = [build_engine(c["topology"], device=dev) for c in spec["cases"]]
    schedules = [build_schedule(c.get("schedule"), spec["t_outer"],
                                spec["t_c"]) for c in spec["cases"]]

    sweep_chunk = spec.get("sweep_chunk")
    n_boundaries = (-(-spec["t_outer"] // sweep_chunk) if sweep_chunk else 1)
    hooks = chaos.hooks_from_env(shard=shard, worker=worker_id,
                                 n_boundaries=n_boundaries,
                                 ckpt_root=ckpt_dir, workdir=workdir)

    def on_boundary(step: int) -> None:
        # faults first (a killed worker must not beat), then the beat, then
        # the lease (a stolen one aborts the run through LeaseLost)
        hooks.at_boundary(step)
        touch_heartbeat(hb_path, step=step)
        if lease_store is not None and lease is not None:
            lease_store.renew(shard, worker_id, lease.token)

    manager = (CheckpointManager(ckpt_dir, on_save=on_boundary)
               if sweep_chunk else None)
    kw = dict(engines=engines, schedules=schedules, r=spec["r"],
              t_outer=spec["t_outer"], t_c=spec["t_c"], seeds=seeds,
              q_true=q_true, device=dev, manager=manager,
              chunk_size=sweep_chunk, **operand)
    if spec.get("net_faults"):
        # every case engine under the spec's seeded fault document
        from repro_torch.core.netfaults import FaultyConsensus
        model, fseed, debias = chaos.net_fault_model_from_dict(
            spec["net_faults"])
        kw["engines"] = [FaultyConsensus(graph=e.graph, faults=model,
                                         seed=fseed, debias=debias,
                                         device=dev) for e in engines]
        sw = netfault_sweep(**kw)
    else:
        sw = sdot_sweep(**kw)
    # the step the runtime restored (a torn newest checkpoint falls back)
    resumed_steps = sw.resumed_step

    i32 = torch.int32
    tree = {"q": sw.q, "seeds": torch.tensor(np.asarray(seeds)),
            "ledger": sw.ledger,
            "resumed_steps": torch.tensor(resumed_steps, dtype=i32),
            "spec_fp": torch.tensor(spec_fingerprint(spec), dtype=i32),
            "port_device": torch.tensor(DEVICE_CODES[dev.type], dtype=i32)}
    if spec["has_q_true"]:
        tree["error_traces"] = torch.from_numpy(np.asarray(sw.error_traces))
    if spec["ragged"]:
        tree["node_counts"] = torch.from_numpy(np.asarray(sw.node_counts))
    touch_heartbeat(hb_path, step=spec["t_outer"])
    save_tree(out_dir, tree, step=shard)
    get_journal().event("publish", "worker", shard=shard,
                        n_seeds=len(seeds), resumed_steps=int(resumed_steps))
    hooks.after_publish(out_dir)
    # the published result supersedes the sweep state; a kill between the
    # publish and this cleanup is redone by the relaunch's check above
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    sp.end(n_seeds=len(seeds), resumed_steps=int(resumed_steps))
    print(f"worker {shard}: published {len(seeds)} seed lanes -> {out_dir}"
          + (f" (resumed from outer step {resumed_steps})"
             if resumed_steps else ""))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("spec", help="path to <workdir>/spec.json")
    ap.add_argument("shard", nargs="?", default=None,
                    help="shard index (pinned mode)")
    ap.add_argument("--fleet", action="store_true",
                    help="elastic mode: lease and steal shards until the "
                         "whole grid is published")
    ap.add_argument("--worker", default=None,
                    help="fleet worker identity (e.g. w0)")
    ap.add_argument("--ttl", type=float, default=30.0,
                    help="lease time-to-live in seconds (fleet mode)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.fleet == (args.shard is not None):
        ap.error("pass a shard index (pinned) or --fleet (elastic), not both")

    workdir = os.path.dirname(os.path.abspath(args.spec))
    with open(args.spec) as f:
        spec = json.load(f)

    from repro_torch.obs import install

    if args.fleet:
        from repro_torch.streaming.fleet import fleet_worker_loop
        worker_id = args.worker or f"w{os.getpid()}"
        # attempt-scoped journal: a respawned slot opens fleet_w0.a1.jsonl
        install(workdir, f"fleet_{worker_id}")
        return fleet_worker_loop(spec, workdir, worker_id, ttl=args.ttl,
                                 device=args.device)
    install(workdir, f"worker_s{int(args.shard)}")
    return run_shard(spec, workdir, int(args.shard), worker=args.worker,
                     device=args.device)


if __name__ == "__main__":
    sys.exit(main())
