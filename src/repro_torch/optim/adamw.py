"""AdamW with dtype-configurable moments: the twin of
``repro/optim/adamw.py``.

The update is the reference's, in float32 whatever the parameter and moment
dtypes: clip by the global norm, bias-corrected moments, decoupled weight
decay, a linear warm-up of the learning rate. ``moment_dtype="bfloat16"``
halves the optimizer's memory. The step counter is an int32 tensor, cast to
float32 for the bias corrections, so no step waits on the host.

Each leaf is updated in slices of ``_CHUNK`` elements: the float32
temporaries of a 545M-element embedding would otherwise take several GB. The
update is elementwise, so the slices give the same bits as one pass.
``donate=True`` writes the new parameters and moments into the given
tensors (the reference's ``donate_argnums``): a training step at full
width cannot hold two copies of its optimizer state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .. import _tree

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "sum_squares"]

_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100


def _lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1),
                       max=1.0)
    return cfg.lr * warm


def adamw_init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    dt = getattr(torch, cfg.moment_dtype)
    leaves = _tree.tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    dev = leaves[0].device if leaves else None
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _slices(n: int):
    return [slice(i, min(i + _CHUNK, n)) for i in range(0, n, _CHUNK)]


def sum_squares(tree) -> torch.Tensor:
    """The sum over leaves (in the reference's leaf order) of each leaf's
    float32 sum of squares, a chunk at a time."""
    total = None
    for x in _tree.tree_leaves(tree):
        flat = x.reshape(-1)
        sq = sum(torch.sum(torch.square(flat[sl].to(torch.float32)))
                 for sl in _slices(flat.numel()))
        total = sq if total is None else total + sq
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of ``sum_squares``."""
    return torch.sqrt(sum_squares(tree))


def adamw_update(grads, state, params, cfg: AdamWConfig, *,
                 donate: bool = False, gnorm=None):
    """(new_params, new_state, grad_norm): one AdamW step. ``grad_norm`` is
    the global norm before clipping. ``donate=True`` updates ``params`` and
    the moments in place and returns them. ``gnorm``: the global norm to
    clip by, where ``grads`` is one rank's block of a sharded gradient
    (the norm of the whole one)."""
    step = state["step"] + 1
    lr = _lr_at(cfg, step)
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=t.device), t)
    mdt = getattr(torch, cfg.moment_dtype)

    _, g_leaves, structure = _tree.flatten_with_names(grads)
    m_leaves = _tree.tree_leaves(state["m"])
    v_leaves = _tree.tree_leaves(state["v"])
    p_leaves = _tree.tree_leaves(params)
    out_p, out_m, out_v = [], [], []
    for g, m, v, p in zip(g_leaves, m_leaves, v_leaves, p_leaves):
        if donate:
            np_, nm, nv = p, m, v
        else:
            np_ = torch.empty_like(p)
            nm = torch.empty(m.shape, dtype=mdt, device=m.device)
            nv = torch.empty(v.shape, dtype=mdt, device=v.device)
        gf, mf, vf, pf = (x.reshape(-1) for x in (g, m, v, p))
        npf, nmf, nvf = (x.view(-1) for x in (np_, nm, nv))
        for sl in _slices(pf.numel()):
            g32 = gf[sl].to(torch.float32) * scale
            m32 = b1 * mf[sl].to(torch.float32) + (1 - b1) * g32
            v32 = b2 * vf[sl].to(torch.float32) + (1 - b2) * torch.square(g32)
            mhat = m32 / bc1
            vhat = v32 / bc2
            p32 = pf[sl].to(torch.float32)
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
                + cfg.weight_decay * p32
            npf[sl] = (p32 - lr * delta).to(p.dtype)
            nmf[sl] = m32.to(mdt)
            nvf[sl] = v32.to(mdt)
        out_p.append(np_)
        out_m.append(nm)
        out_v.append(nv)
    new_params = _tree.unflatten(structure, out_p)
    new_state = {"m": _tree.unflatten(structure, out_m),
                 "v": _tree.unflatten(structure, out_v), "step": step}
    return new_params, new_state, gnorm
