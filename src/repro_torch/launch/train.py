"""Training driver: the twin of ``repro/launch/train.py``.

Fault tolerance:
  * auto-resume: on start the newest checkpoint under --ckpt-dir is
    restored (params, optimizer, PSA state, step). ``make_lm_batch`` is a
    function of (seed, step), so a restarted run replays the same batches
    and ends with the same bits as one that never stopped.
  * atomic saves, written off the critical path (checkpoint/manager.py).
  * ``--mesh multipod`` spawns 2 pod ranks (launch/mesh.spawn_ranks). A
    pod's error feedback is its own, so each pod keeps its checkpoints under
    ``<ckpt-dir>/pod<i>``, and a restart resumes at the newest step that
    every pod has.
  * a non-finite loss stops the run.

Usage (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --reduced --steps 50 --batch 4 --seq 32 --ckpt-dir /tmp/ckpt \\
      --device cpu
Multi-pod PSA-compressed (the paper's technique in the optimizer):
  ... --psa --mesh multipod [--backend gloo|nccl]
Without ``--device`` the run needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..checkpoint.manager import CheckpointManager
from ..configs import get_arch, get_psa_config, reduced_config
from ..configs.base import ModelConfig
from ..data.pipeline import make_lm_batch
from ..models.transformer import init_params
from ..optim.adamw import AdamWConfig, adamw_init
from ..optim.psa_compress import compression_ratio, psa_init
from ..train.step import make_psa_train_step, make_train_step, shard_batch
from .mesh import make_test_mesh, rank_device, spawn_ranks

__all__ = ["train", "main"]


def train(args, cfg: Optional[ModelConfig] = None) -> dict:
    """Run (or resume) a training run; returns the first and last losses,
    the steps run and the loop's wall time. ``cfg`` overrides ``--arch``.

    ``--mesh multipod`` outside a process group spawns 2 pod ranks, which
    run this and return pod 0's result; inside one (a caller's ranks) the
    world's ranks are the pods.
    """
    if args.mesh == "multipod" and not dist.is_initialized():
        return spawn_ranks(_pod_rank, 2, backend=args.backend,
                           device=args.device, args=(args, cfg))[0]
    if args.mesh == "multipod":
        dev = rank_device(args.device, dist.get_rank())
        pod = make_test_mesh(multi_pod=True, device=dev).axis("pod")
    elif args.mesh == "single":
        dev, pod = resolve_device(args.device), None
    else:
        raise ValueError(args.mesh)
    return _train(args, cfg, dev, pod)


def _pod_rank(rank, world, dev, args, cfg):
    return train(args, cfg)


def _common_step(mgr: CheckpointManager, pod, dev) -> Optional[int]:
    """The newest saved step of this rank, or with pods of every pod."""
    step = mgr.latest_step()
    if pod is None:
        return step
    t = torch.tensor([-1 if step is None else step], device=dev)
    step = int(pod.all_reduce_(t, op=dist.ReduceOp.MIN)[0])
    return None if step < 0 else step


def _train(args, cfg, dev, pod) -> dict:
    if cfg is None:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = reduced_config(cfg)
    opt = AdamWConfig(lr=args.lr, warmup_steps=args.warmup)
    psa = get_psa_config() if args.psa else None
    if psa is not None and args.psa_rank:
        psa = dataclasses.replace(psa, rank=args.psa_rank)
    if psa is not None and pod is None:
        raise ValueError("--psa needs --mesh multipod (a pod axis)")
    lead = pod is None or pod.index == 0
    log = print if lead else (lambda *a, **k: None)

    params = init_params(torch.Generator(device=dev).manual_seed(args.seed),
                         cfg, device=dev)
    opt_state = adamw_init(params, opt)
    psa_state = psa_init(params, psa) if psa else None
    if psa:
        step_fn, refresh_fn = make_psa_train_step(cfg, opt, psa, group=pod)
        log(f"[psa] cross-pod compression ratio: "
            f"{compression_ratio(params, psa):.4f}")
    else:
        step_fn = make_train_step(cfg, opt, group=pod)

    def tree():
        out = {"params": params, "opt": opt_state}
        if psa_state is not None:
            out["psa"] = psa_state
        return out

    mgr = None
    if args.ckpt_dir:
        root = (args.ckpt_dir if pod is None
                else os.path.join(args.ckpt_dir, f"pod{pod.index}"))
        mgr = CheckpointManager(root, keep_last=args.keep_last)
    start_step = 0
    if mgr is not None:
        step = _common_step(mgr, pod, dev)
        if step is not None:
            restored, _ = mgr.restore(tree(), step=step)
            params, opt_state = restored["params"], restored["opt"]
            psa_state = restored.get("psa", psa_state)
            start_step = step
            log(f"[resume] restored step {step} from {args.ckpt_dir}")

    losses = []
    t0 = time.perf_counter()
    for t in range(start_step, args.steps):
        batch = make_lm_batch(cfg, args.data_seed, t, args.batch, args.seq,
                              device=dev)
        if pod is not None:
            batch = shard_batch(batch, pod.index, pod.size)
        if psa:
            if t % psa.refresh_every == 0:
                psa_state = refresh_fn(params, psa_state, batch)
            params, opt_state, psa_state, metrics = step_fn(
                params, opt_state, psa_state, batch)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss at step {t}")
        if t % args.log_every == 0:
            log(f"step {t:5d}  loss {loss:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if (mgr is not None and (t + 1) % args.ckpt_every == 0
                and t + 1 < args.steps):       # the last step saves below
            mgr.save(t + 1, tree(), blocking=False)   # off the critical path
    wall = time.perf_counter() - t0
    if mgr is not None:
        mgr.wait()
        mgr.save(args.steps, tree())
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps_run": len(losses), "wall_s": wall}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--psa", action="store_true",
                    help="PSA-compressed cross-pod gradient reduction")
    ap.add_argument("--psa-rank", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--keep-last", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="process-group backend of --mesh multipod")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    out = train(parser().parse_args(argv))
    print(f"done: {out}")
    return out


if __name__ == "__main__":
    main()
