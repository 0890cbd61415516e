"""Multi-process Monte-Carlo sweep launcher with supervision, leases and
chaos: the twin of ``repro/streaming/launcher.py``.

``core/sweep.py`` runs a seeds x cases grid as one program in one process.
``launch_sweep`` shards the grid over worker processes (one a host on a
real fleet; here subprocesses sharing the card):

    launch_sweep(...)
      -> writes <workdir>/spec.json (topologies, schedules, the shards' seed
         lists: everything a worker needs to rebuild its slice) and
         <workdir>/problem.npz (cov stacks or raw data blocks, the optional
         ground truth)
      -> runs the grid as ``n_shards`` leasable shards
         (``core.sweep.slice_seed_shards``) over ``n_workers`` workers
         (``python -m repro_torch.streaming.worker``); each publishes its
         shard's result atomically into <workdir>/worker_<shard>/result
      -> merges the published shards along the seed axis into one
         ``SweepResult``: a shard's lanes are those of a single-process
         sweep over the shard's seeds, bit for bit.

Supervision is a concurrent poll loop against one shared deadline: a dead
worker is seen within one poll interval, a wedged one by a stale heartbeat
(workers touch ``worker_<shard>/heartbeat`` at every chunk boundary), and a
failed shard is retried under a budget with exponential backoff and
jitter. ``elastic=True`` runs un-pinned fleet workers that lease, steal and
resume shards (``streaming/fleet.py``). ``chaos_plan`` injects a seeded
``streaming.chaos.FaultPlan`` into the workers through ``REPRO_CHAOS_PLAN``;
``net_faults`` runs every worker's gossip through ``FaultyConsensus``.

A shard whose result is already published is never recomputed, so a
killed launcher resumes where it stopped. A result is reused only if it
carries this spec's fingerprint (``spec_fingerprint``, the reference's
digest of the same spec) and was published by the port on the launch's
device type: the port draws its inits from its own torch stream, so a
result the reference published (``jax.random`` inits) or one from the other
device type is refused with an error, never merged. A reference worker's
mid-grid checkpoint carries every draw in its state and is resumed, as
``runtime.run_sweep`` resumes it.

Workers run on the card unless ``device`` says otherwise (``--device``);
on the card the launcher builds every kernel before it spawns, so the
workers, each with its own CUDA context on the one card, load the built
libraries instead of racing nvcc.

Topologies and schedules travel as small JSON specs (``build_engine`` /
``build_schedule``): graph constructions are seed-deterministic, so a
relaunched process rebuilds the same engine.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
import shutil
import subprocess
import sys
import time
import zipfile
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..checkpoint.manager import restore_tree
from ..core.consensus import DenseConsensus, consensus_schedule
from ..core.metrics import CommLedger
from ..core.sweep import SweepResult, slice_seed_shards
from ..core.topology import complete, erdos_renyi, ring, star, torus2d
from ..obs import Journal, obs_dir_for
from .chaos import (ENV_PLAN, FaultPlan, net_faults_from_env,
                    validate_net_fault_doc)
from .fleet import LeaseStore, read_heartbeat

__all__ = ["build_engine", "build_schedule", "launch_sweep",
           "spec_fingerprint", "DEVICE_CODES"]

_SPEC = "spec.json"
_PROBLEM = "problem.npz"
_CHAOS_PLAN = "chaos_plan.json"

# restore-time failure modes expected of an absent, stale or torn shard;
# anything else goes on the resume report instead of a silent recompute
_EXPECTED_RESTORE_ERRORS = (OSError, ValueError, KeyError, EOFError,
                            zipfile.BadZipFile)

# the device type a published result was computed on (its ``port_device``
# leaf, which also marks the result as the port's)
DEVICE_CODES = {"cpu": 0, "cuda": 1}


def build_engine(topo: dict, device: DeviceLike = None) -> DenseConsensus:
    """Topology spec -> consensus engine on ``device`` (CUDA by default)."""
    kind = topo["kind"]
    if kind == "ring":
        g = ring(topo["n"])
    elif kind == "star":
        g = star(topo["n"])
    elif kind == "complete":
        g = complete(topo["n"])
    elif kind == "torus2d":
        g = torus2d(topo["rows"], topo["cols"])
    elif kind == "er":
        g = erdos_renyi(topo["n"], topo["p"], seed=topo.get("seed", 0))
    else:
        raise ValueError(f"unknown topology kind: {kind}")
    return DenseConsensus(g, device=device)


def build_schedule(sched: Optional[dict], t_outer: int,
                   t_c: int) -> np.ndarray:
    """Schedule spec -> (t_outer,) consensus budgets."""
    if sched is None:
        return consensus_schedule("const", t_outer, t_max=t_c)
    if "values" in sched:
        return np.asarray(sched["values"])[:t_outer]
    return consensus_schedule(sched["kind"], t_outer,
                              t_max=sched.get("t_max", t_c),
                              cap=sched.get("cap"))


def _worker_dir(workdir: str, shard: int) -> str:
    return os.path.join(workdir, f"worker_{shard}")


def _result_dir(workdir: str, shard: int) -> str:
    return os.path.join(_worker_dir(workdir, shard), "result")


def _heartbeat_path(workdir: str, shard: int) -> str:
    return os.path.join(_worker_dir(workdir, shard), "heartbeat")


def spec_fingerprint(spec: dict) -> int:
    """Stable 31-bit digest of the sweep spec, the reference's: stamped into
    every published result and checked before a shard is reused, so a
    workdir reused with a changed spec relaunches instead of merging stale
    shards. ``sweep_chunk`` is left out: chunking keeps the bits, so a
    resume may change the chunk size."""
    blob = json.dumps({k: v for k, v in spec.items() if k != "sweep_chunk"},
                      sort_keys=True).encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:4], "big") >> 1


def _result_like(spec: dict, port: bool = True, with_resumed: bool = True):
    """Structure template for ``restore_tree`` (values are ignored): the
    port's result, or (``port=False``) the reference's."""
    like = {"q": torch.zeros(()), "seeds": torch.zeros(()),
            "ledger": CommLedger(),
            "spec_fp": torch.zeros((), dtype=torch.int32)}
    if port:
        like["port_device"] = torch.zeros((), dtype=torch.int32)
    if with_resumed:
        like["resumed_steps"] = torch.zeros((), dtype=torch.int32)
    if spec["has_q_true"]:
        like["error_traces"] = torch.zeros(())
    if spec["ragged"]:
        like["node_counts"] = torch.zeros(())
    return like


def _refuse_foreign(path: str, spec: dict, shard: int) -> None:
    """Raise if ``path`` holds a result of this spec that the reference
    published: its lanes start from ``jax.random`` inits, so merging them
    with the port's would give a grid that no single sweep gives."""
    for with_resumed in (True, False):
        try:
            tree = restore_tree(path, _result_like(spec, False, with_resumed))
        except _EXPECTED_RESTORE_ERRORS:
            continue
        if int(tree["spec_fp"]) == spec_fingerprint(spec):
            raise ValueError(
                f"shard {shard}: {path} holds a result the JAX reference "
                "published; its lanes start from the reference's own draws, "
                "which the port does not replay, so it is not merged with "
                "the port's shards; launch into a fresh workdir")


def _load_result(workdir: str, spec: dict, shard: int,
                 unexpected: Optional[dict] = None,
                 device: DeviceLike = None):
    """The shard's published result, or None if absent, stale or corrupt.

    A result published under another spec fails the fingerprint and is
    recomputed. A result the reference published for this spec, or the
    port's from another device type than ``device``'s (when given), raises:
    it is a valid result of another sweep, not one to recompute quietly or
    to merge. Only the expected restore failures are swallowed; anything
    else is recorded in ``unexpected`` (shard -> repr) for the resume
    report."""
    path = _result_dir(workdir, shard)
    if not os.path.exists(os.path.join(path, "manifest.json")):
        return None
    try:
        tree = restore_tree(path, _result_like(spec))
    except _EXPECTED_RESTORE_ERRORS:
        _refuse_foreign(path, spec, shard)
        return None
    except Exception as e:                       # noqa: BLE001 — surfaced
        if unexpected is not None:
            unexpected[shard] = f"{type(e).__name__}: {e}"
        return None
    if int(tree["spec_fp"]) != spec_fingerprint(spec):
        return None
    if device is not None:
        want = DEVICE_CODES[torch.device(device).type]
        if int(tree["port_device"]) != want:
            raise ValueError(
                f"shard {shard}: {path} was published on "
                f"{_device_name(int(tree['port_device']))}, this launch "
                f"runs on {torch.device(device).type}; the two round "
                "differently, so they are not merged; launch into a fresh "
                "workdir")
    return tree


def _device_name(code: int) -> str:
    return {v: k for k, v in DEVICE_CODES.items()}.get(code, f"code {code}")


def _spawn(args, env, log_path) -> subprocess.Popen:
    """Spawn a worker with stdout and stderr appended to ``log_path`` (full
    pipes would wedge the very workers being supervised)."""
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    log = open(log_path, "ab")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.streaming.worker", *args],
            stdout=log, stderr=log, env=env)
    finally:
        log.close()


def _tail(log_path: str, n: int = 2000) -> str:
    try:
        with open(log_path, "rb") as f:
            return f.read()[-n:].decode(errors="replace")
    except OSError:
        return "<no worker log>"


def _trace_tail(workdir: str, proc: str, n: int = 8) -> str:
    """The worker's journal tail, with any span left open at its death, so a
    failure report names the phase the worker died in ("" when tracing is
    off or the worker never journaled)."""
    from ..obs.cli import forensics_report
    obs_dir = obs_dir_for(workdir)
    if obs_dir is None or not os.path.isdir(obs_dir):
        return ""
    try:
        text, _ = forensics_report(obs_dir, last=n, proc=proc)
    except Exception:
        return ""
    return text.strip()


def _fail_report(workdir: str, proc: str, log_path: str) -> str:
    out = f"last log tail:\n{_tail(log_path)}"
    trace = _trace_tail(workdir, proc)
    if trace:
        out += f"\njournal tail ({proc}):\n{trace}"
    return out


def _backoff(base: float, attempt: int, rng: random.Random) -> float:
    """Exponential backoff with jitter: base * 2^(attempt-1) * U[1, 1.25]."""
    return base * (2.0 ** max(0, attempt - 1)) * (1.0 + 0.25 * rng.random())


# ---------------------------------------------------------------------------
# supervision loops
# ---------------------------------------------------------------------------
def _supervise_pinned(spec_path, workdir, spec, pending, env, *, n_workers,
                      retries, timeout, stall_timeout, backoff_base,
                      poll_interval, results, unexpected, attempts, device,
                      journal=None):
    """One worker process a pending shard, polled concurrently against one
    shared deadline, stale-heartbeat kills, retry budgets with backoff."""
    jl = journal if journal is not None else Journal.noop()
    rng = random.Random(0xC0FFEE)
    deadline = time.monotonic() + timeout
    pending = set(pending)
    next_spawn = {i: 0.0 for i in pending}
    procs, spawn_wall, last_log = {}, {}, {}
    try:
        while pending:
            now = time.monotonic()
            if now > deadline:
                raise RuntimeError(
                    f"sweep launch exceeded its shared deadline "
                    f"({timeout:.0f}s) with shards {sorted(pending)} "
                    f"unfinished")
            for i in sorted(pending - set(procs)):
                if len(procs) >= n_workers:
                    break
                if now < next_spawn[i]:
                    continue
                log = os.path.join(_worker_dir(workdir, i),
                                   f"log_{attempts[i]}.txt")
                last_log[i] = log
                procs[i] = _spawn([spec_path, str(i), "--device", device],
                                  env, log)
                spawn_wall[i] = time.time()
                jl.event("spawn", "launcher", shard=i,
                         launch_attempt=attempts[i], pid_child=procs[i].pid)
            reaped = []
            for i, p in procs.items():
                rc = p.poll()
                if rc is None and stall_timeout:
                    # a progress beat of this attempt, gone quiet: startup
                    # (imports, the first chunk) never reads as a stall
                    try:
                        beat = os.path.getmtime(_heartbeat_path(workdir, i))
                    except OSError:
                        beat = None
                    if (beat is not None and beat > spawn_wall[i]
                            and time.time() - beat > stall_timeout):
                        hb = read_heartbeat(_heartbeat_path(workdir, i))
                        hb_step = None if hb is None else hb.get("step")
                        age = time.time() - beat
                        print(f"launcher: shard {i} heartbeat {age:.1f}s "
                              f"stale (last step "
                              f"{'?' if hb_step is None else hb_step}) — "
                              f"killing wedged worker")
                        jl.event("stall_kill", "launcher", shard=i,
                                 beat_age_s=round(age, 3), step=hb_step)
                        p.kill()
                        p.wait()
                        rc = p.returncode
                if rc is None:
                    continue
                reaped.append(i)
                # a worker may die after publishing: the result wins
                res = _load_result(workdir, spec, i, unexpected, device)
                attempts[i] += 1
                if res is not None:
                    results[i] = res
                    pending.discard(i)
                    jl.event("shard_done", "launcher", shard=i,
                             launch_attempts=attempts[i], rc=rc)
                    continue
                if attempts[i] > retries:
                    raise RuntimeError(
                        f"sweep shard {i} failed after {retries + 1} "
                        f"attempts; "
                        f"{_fail_report(workdir, f'worker_s{i}', last_log[i])}")
                next_spawn[i] = now + _backoff(backoff_base, attempts[i],
                                               rng)
                jl.event("retry", "launcher", shard=i, rc=rc,
                         launch_attempt=attempts[i],
                         backoff_s=round(next_spawn[i] - now, 3))
            for i in reaped:
                procs.pop(i)
            if pending:
                time.sleep(poll_interval)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _supervise_elastic(spec_path, workdir, spec, pending, env, *, n_workers,
                       retries, timeout, lease_ttl, backoff_base,
                       poll_interval, results, unexpected, attempts, device,
                       journal=None):
    """``n_workers`` un-pinned fleet workers lease and steal shards; the
    launcher keeps the worker slots alive (a dead one is respawned under a
    per-slot budget) and polls for published results."""
    jl = journal if journal is not None else Journal.noop()
    rng = random.Random(0xE1A571C)
    deadline = time.monotonic() + timeout
    pending = set(pending)
    slot_attempts = {s: 0 for s in range(n_workers)}
    next_spawn = {s: 0.0 for s in range(n_workers)}
    procs, last_log = {}, {}
    try:
        while pending:
            now = time.monotonic()
            if now > deadline:
                raise RuntimeError(
                    f"elastic sweep launch exceeded its deadline "
                    f"({timeout:.0f}s) with shards {sorted(pending)} "
                    f"unfinished")
            for s in range(n_workers):
                p = procs.get(s)
                if p is not None:
                    if p.poll() is None:
                        continue
                    # a fleet worker exits only once every shard is
                    # published; an exit with work pending uses the budget
                    rc = p.returncode
                    procs.pop(s)
                    slot_attempts[s] += 1
                    jl.event("slot_exit", "launcher", slot=s, rc=rc,
                             slot_attempts=slot_attempts[s])
                    if slot_attempts[s] > retries:
                        continue
                    next_spawn[s] = now + _backoff(backoff_base,
                                                   slot_attempts[s], rng)
                    continue
                if now < next_spawn[s] or slot_attempts[s] > retries:
                    continue
                log = os.path.join(workdir, f"fleet_w{s}",
                                   f"log_{slot_attempts[s]}.txt")
                last_log[s] = log
                procs[s] = _spawn(
                    [spec_path, "--fleet", "--worker", f"w{s}",
                     "--ttl", str(lease_ttl), "--device", device], env, log)
                jl.event("spawn", "launcher", slot=s,
                         launch_attempt=slot_attempts[s],
                         pid_child=procs[s].pid)
            for i in sorted(pending):
                res = _load_result(workdir, spec, i, unexpected, device)
                if res is not None:
                    results[i] = res
                    attempts[i] += 1
                    pending.discard(i)
            if pending:
                if not procs and all(a > retries
                                     for a in slot_attempts.values()):
                    tails = "\n".join(
                        _fail_report(workdir, f"fleet_w{s}", log)
                        for s, log in last_log.items())
                    raise RuntimeError(
                        f"all {n_workers} fleet worker slots exhausted "
                        f"their {retries + 1}-attempt budgets with shards "
                        f"{sorted(pending)} unfinished;\n{tails}")
                time.sleep(poll_interval)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------
def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _load_doc(doc: Union[dict, str, None]) -> Optional[dict]:
    """A net-fault document: a dict, inline JSON or a path to one (None:
    ``REPRO_NET_FAULTS``)."""
    if doc is None:
        return net_faults_from_env()
    if isinstance(doc, str):
        if doc.lstrip().startswith("{"):
            return json.loads(doc)
        with open(doc) as f:
            return json.load(f)
    return doc


def launch_sweep(
    *,
    covs=None,
    data: Optional[Sequence] = None,
    cases: Sequence[dict],
    r: int,
    t_outer: int,
    t_c: int = 50,
    seeds: Sequence[int],
    q_true=None,
    workdir: str,
    n_workers: int = 2,
    n_shards: Optional[int] = None,
    retries: int = 1,
    timeout: float = 900.0,
    sweep_chunk: Optional[int] = None,
    elastic: bool = False,
    stall_timeout: Optional[float] = None,
    lease_ttl: float = 30.0,
    backoff_base: float = 0.5,
    poll_interval: float = 0.2,
    chaos_plan: Union[FaultPlan, dict, str, None] = None,
    net_faults: Union[dict, str, None] = None,
    device: DeviceLike = None,
) -> SweepResult:
    """Shard an ``sdot_sweep`` case x seed grid over supervised workers.

    ``covs``: one (N, d, d) stack shared by every case, or a list with one
    stack a case (ragged node counts pad as in ``sdot_sweep``); or ``data``:
    N raw (d, n_i) blocks shared by every case (Step 5 through the
    gram-apply kernel). ``cases``: ``{"topology": {...}, "schedule":
    {...}}`` specs (``build_engine`` / ``build_schedule``). The seeds split
    contiguously into ``n_shards`` shards (default one a worker), so the
    merge keeps seed order and a shard's lanes are a single-process
    sweep's over its seeds.

    Supervision: one shared ``timeout``; a dead worker is respawned after
    backoff under ``retries``; with ``sweep_chunk`` a worker whose
    heartbeat is quiet for ``stall_timeout`` seconds (default 60, 0 off) is
    killed and retried. ``elastic=True`` runs fleet workers that lease,
    steal and resume shards (``lease_ttl``: when a silent shard becomes
    stealable). ``sweep_chunk`` checkpoints each worker's sweep state every
    ``sweep_chunk`` outer iterations, so a killed or robbed worker resumes
    mid-grid with the same bits. ``SweepResult.resume_report`` records
    reused shards, restored steps, attempts, stolen shards (elastic) and
    unexpected restore errors. ``chaos_plan`` (a ``FaultPlan``, its dict or
    a path) injects seeded faults into the workers; ``net_faults`` (a
    document, inline JSON or a path; default ``REPRO_NET_FAULTS``) runs
    every worker's gossip through ``FaultyConsensus`` and enters the spec's
    fingerprint. ``device``: where the workers run (CUDA by default).
    """
    dev = resolve_device(device)
    if (covs is None) == (data is None):
        raise ValueError("provide exactly one of covs / data")
    os.makedirs(workdir, exist_ok=True)
    seeds = [int(s) for s in seeds]
    n_workers = max(1, min(int(n_workers), len(seeds)))
    shards = slice_seed_shards(seeds, n_shards if n_shards else n_workers)
    n_shards = len(shards)

    ragged = isinstance(covs, (list, tuple))
    if ragged and len(covs) not in (1, len(cases)):
        raise ValueError(f"per-case covs must zip-broadcast with the "
                         f"cases: got {len(covs)} cov stacks for "
                         f"{len(cases)} cases")
    net_faults = _load_doc(net_faults)
    if net_faults is not None:
        validate_net_fault_doc(net_faults)
        if ragged:
            raise ValueError("net_faults requires a uniform node count "
                             "across cases (ragged per-case covs given)")
        if data is not None:
            raise ValueError("net_faults sweeps take covs, not raw data")
    if elastic and sweep_chunk is None:
        # a steal without checkpoints would recompute the shard from scratch
        sweep_chunk = max(1, int(t_outer) // 5)
    spec = {
        "algo": "sdot",
        "r": int(r),
        "t_outer": int(t_outer),
        "t_c": int(t_c),
        "cases": list(cases),
        "shards": shards,
        "ragged": ragged,
        "n_cov_stacks": len(covs) if ragged else 1,
        "has_q_true": q_true is not None,
        "sweep_chunk": int(sweep_chunk) if sweep_chunk else None,
    }
    if data is not None:
        spec["operand"] = "data"
        spec["n_blocks"] = len(data)
    if net_faults is not None:
        spec["net_faults"] = net_faults
    spec_path = os.path.join(workdir, _SPEC)
    with open(spec_path, "w") as f:
        json.dump(spec, f, indent=2)

    # a changed spec invalidates the workers' intermediate checkpoints
    # (published results carry their own fingerprint)
    fp = str(spec_fingerprint(spec))
    fp_path = os.path.join(workdir, "spec_fp")
    if os.path.exists(fp_path):
        with open(fp_path) as f:
            if f.read().strip() != fp:
                for name in os.listdir(workdir):
                    ckpt = os.path.join(workdir, name, "ckpt")
                    if name.startswith("worker_") and os.path.isdir(ckpt):
                        shutil.rmtree(ckpt, ignore_errors=True)
                shutil.rmtree(os.path.join(workdir, "leases"),
                              ignore_errors=True)
    with open(fp_path, "w") as f:
        f.write(fp)

    arrays = {}
    if data is not None:
        for i, block in enumerate(data):
            arrays[f"data_{i}"] = _host(block)
    elif ragged:
        for ci, c in enumerate(covs):
            arrays[f"covs_{ci}"] = _host(c)
    else:
        arrays["covs"] = _host(covs)
    if q_true is not None:
        arrays["q_true"] = _host(q_true)
    np.savez(os.path.join(workdir, _PROBLEM), **arrays)

    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    if chaos_plan is not None:
        if isinstance(chaos_plan, dict):
            chaos_plan = FaultPlan(chaos_plan.get("faults", []),
                                   seed=chaos_plan.get("seed", 0))
        if hasattr(chaos_plan, "dump"):
            chaos_plan = chaos_plan.dump(os.path.join(workdir, _CHAOS_PLAN))
        env[ENV_PLAN] = str(chaos_plan)
    else:
        env.pop(ENV_PLAN, None)
    if stall_timeout is None:
        stall_timeout = 60.0 if sweep_chunk else 0.0

    unexpected: dict = {}
    results = {i: _load_result(workdir, spec, i, unexpected, dev)
               for i in range(n_shards)}
    pending = [i for i, t in results.items() if t is None]
    reused = sorted(i for i, t in results.items() if t is not None)
    for i in pending:
        shutil.rmtree(_result_dir(workdir, i), ignore_errors=True)
    attempts = {i: 0 for i in range(n_shards)}
    if pending:
        if dev.type == "cuda":
            # every worker loads these libraries; none runs nvcc itself
            from ..kernels import _build
            _build.build_all()
        # the launcher's own journal (launch_sweep is a library call: the
        # process journal belongs to its caller)
        obs_dir = obs_dir_for(workdir)
        jl = (Journal.open(obs_dir, "launcher") if obs_dir is not None
              else Journal.noop())
        supervise = _supervise_elastic if elastic else _supervise_pinned
        kw = ({"lease_ttl": lease_ttl} if elastic
              else {"stall_timeout": stall_timeout})
        try:
            with jl.span("supervise", "launcher", n_shards=n_shards,
                         n_workers=n_workers, elastic=elastic,
                         pending=sorted(pending),
                         chaos=chaos_plan is not None):
                supervise(spec_path, workdir, spec, pending, env,
                          n_workers=n_workers, retries=retries,
                          timeout=timeout, backoff_base=backoff_base,
                          poll_interval=poll_interval, results=results,
                          unexpected=unexpected, attempts=attempts,
                          device=dev.type, journal=jl, **kw)
        finally:
            jl.close()

    trees = [results[i] for i in range(n_shards)]
    report = {
        # shards reused wholesale: their case x seed sub-grids were skipped
        "reused_shards": reused,
        "skipped_grid_points": sum(len(shards[i]) for i in reused)
        * len(cases),
        # the outer step each shard's restored sweep state carried
        "worker_resumed_steps": {i: int(t["resumed_steps"])
                                 for i, t in enumerate(trees)},
        # attempts this launch spent a shard (0: reused, 1: first try)
        "attempts": attempts,
    }
    if unexpected:
        report["load_errors"] = dict(unexpected)
    if elastic:
        leases = LeaseStore(workdir, ttl=lease_ttl).snapshot()
        report["lease_owners"] = {s: lease.owners
                                  for s, lease in leases.items()}
        report["stolen_shards"] = sorted(
            s for s, lease in leases.items() if len(set(lease.owners)) > 1)
    return SweepResult.merge_shards(
        trees, n_cases=len(cases), has_err=spec["has_q_true"],
        ragged=spec["ragged"], resume_report=report)
