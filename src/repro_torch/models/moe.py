"""Token-choice top-k MoE FFN. The twin of ``repro/models/moe.py``.

Routing assigns each (token, choice) pair a slot of its expert's buffer:
softmax over the router's f32 logits, top-k, gates renormalised, the pairs
grouped by expert with a stable sort, each pair's rank within its expert,
and pairs ranked past the capacity ``cap`` dropped to the spare slot
``e * cap``. Dispatch scatters the tokens into an ``(e * cap + 1, d)``
buffer whose last row is that spare slot, the experts' SwiGLU FFNs run as
``torch.bmm`` over the expert axis, and combine gathers each kept pair's
output back, weighted by its gate (kimi adds a dense shared expert).

Routing runs per data shard when ``act_specs["moe"]`` gives a shard
count, as the reference's does: each shard's tokens are sorted, and capped
at a capacity, on their own; with one shard that is global routing. The
reference leaves these products to XLA, so they stay ``torch.bmm`` /
``torch.matmul`` here: no Pallas kernel is on this path.

Split over "model" (``model=``): the expert stacks hold a rank's E / tp
experts, a contiguous block, and the shared expert's columns are cut as
the dense FFN's. Every model rank routes the same tokens with the same
replicated router, so the slots are the global ones; a rank keeps the
pairs its experts own (the rest go to its spare slot) and returns its
part of the combine, which the caller reduces over "model".
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from .layers import init_dense, normal

__all__ = ["init_moe", "apply_moe", "moe_capacity", "route", "router_probs",
           "assign_slots"]


def moe_capacity(m: MoEConfig, n_tokens: int) -> int:
    cap = int(m.capacity_factor * m.top_k * n_tokens / m.n_experts)
    return max(8, -(-cap // 8) * 8)  # round up to 8


def _expert_stack(gen: Optional[torch.Generator], e: int, d_in: int,
                  d_out: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """(e, d_in, d_out) at the reference's scale d_in^-0.5, drawn one
    expert at a time, so the f32 draw held at once is one expert's (kimi's
    stack is 11 GB in bf16, 22 GB as one f32 draw)."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=device)
    if device.type != "meta":
        for i in range(e):
            out[i] = normal(gen, (d_in, d_out), d_in ** -0.5, dtype, device)
    return out


def init_moe(gen: Optional[torch.Generator], cfg: ModelConfig,
             device: torch.device) -> Dict[str, object]:
    m = cfg.moe
    d, f = cfg.d_model, m.d_expert
    dt = cfg.torch_dtype
    p: Dict[str, object] = {
        "router": init_dense(gen, d, m.n_experts, torch.float32, device),
        "w_gate": _expert_stack(gen, m.n_experts, d, f, dt, device),
        "w_up": _expert_stack(gen, m.n_experts, d, f, dt, device),
        "w_down": _expert_stack(gen, m.n_experts, f, d, dt, device),
    }
    if m.n_shared_experts:
        fs = m.d_expert * m.n_shared_experts
        p["shared"] = {
            "w_gate": init_dense(gen, d, fs, dt, device),
            "w_up": init_dense(gen, d, fs, dt, device),
            "w_down": init_dense(gen, fs, d, dt, device),
        }
    return p


def router_probs(xf: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """Softmax over the experts of the router's logits, in f32. (t, e)"""
    return torch.softmax((xf @ router.to(xf.dtype)).float(), dim=-1)


def assign_slots(eidx: torch.Tensor, e: int, cap: int):
    """For each (token, choice) pair of the expert choices ``eidx`` (t, k),
    in token-major order: whether it is kept (ranked below ``cap`` within
    its expert, in token order) and its slot in the (e * cap + 1)-row
    buffer, the spare slot e * cap for a dropped pair."""
    flat_e = eidx.reshape(-1)                                    # (t*k,)
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)                   # by expert
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(n, device=eidx.device) - seg_start
    keep = pos_in_e < cap
    slot_sorted = torch.where(keep, sorted_e * cap + pos_in_e.clamp_max(
        cap - 1), e * cap)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=eidx.device))
    return keep[inv], slot_sorted[inv]


def route(xf: torch.Tensor, router: torch.Tensor, m: MoEConfig, cap: int):
    """Slot assignment of the tokens ``xf`` (t, d): the gates (t, k), top-k
    of the router's softmax renormalised, and ``assign_slots`` of their
    experts."""
    gates, eidx = torch.topk(router_probs(xf, router), m.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return (gates, *assign_slots(eidx, m.n_experts, cap))


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig,
              act_specs=None, model=None) -> torch.Tensor:
    """x: (b, s, d) -> (b, s, d).

    ``act_specs["moe"]`` (``models/sharding.activation_specs``) gives the
    number of data shards ``n_dp``: the t = b s tokens, in order, split
    into that many shards (one when t does not divide), each routed on its
    own with the capacity ``moe_capacity(m, t / n_dp)`` for each (shard,
    expert) pair, as the reference routes them. The shards' buffers go shard-major to
    expert-major for one batched FFN over the experts and back. Its mesh
    axes (``dp``, ``e``) change nothing here. Without it every token is
    routed together."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    k, e = m.top_k, m.n_experts
    spec = (act_specs or {}).get("moe") or {}
    n = spec.get("n_dp", 1) or 1
    if t % n:
        n = 1
    t_loc = t // n
    cap = moe_capacity(m, t_loc)
    xs = x.reshape(n, t_loc, d)
    plans = [route(xs[i], p["router"], m, cap) for i in range(n)]
    gates, keep, slot = (torch.stack(part) for part in zip(*plans))
    e_loc = p["w_gate"].shape[0]
    if e_loc != e:
        # this rank's experts [e0, e0 + e_loc): their slots, shifted to 0
        lo = (model.index if model is not None else 0) * e_loc * cap
        keep = keep & (slot >= lo) & (slot < lo + e_loc * cap)
        slot = torch.where(keep, slot - lo, e_loc * cap)
        e = e_loc
    tok_of = torch.arange(t_loc, device=x.device).repeat_interleave(k)

    # dispatch: kept pairs to their slots, dropped ones (zeros) to their
    # shard's spare slot, each shard's (e cap + 1)-row buffer in one tensor
    contrib = torch.where(keep[..., None], xs[:, tok_of], 0.0)
    rows = e * cap + 1
    base = torch.arange(n, device=x.device)[:, None] * rows
    buf = xs.new_zeros((n * rows, d)).index_copy_(
        0, (slot + base).reshape(-1), contrib.reshape(-1, d))
    # shard-major -> expert-major: (e, n cap, d)
    buf = buf.reshape(n, rows, d)[:, :-1].reshape(n, e, cap, d)
    buf = buf.transpose(0, 1).reshape(e, n * cap, d)

    # the experts' FFNs, batched over the expert axis
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    yb = torch.bmm(F.silu(g) * u, p["w_down"])
    # expert-major -> shard-major: (n, e cap, d)
    yb = yb.reshape(e, n, cap, d).transpose(0, 1).reshape(n, e * cap, d)

    # combine: a token's k choices are rows k i .. k i + k - 1 of its shard
    picked = yb[torch.arange(n, device=x.device)[:, None],
                slot.clamp_max(e * cap - 1)]
    ytk = torch.where(keep[..., None], picked, 0.0)
    y = (ytk * gates.reshape(n, -1, 1).to(ytk.dtype)).reshape(
        t, k, d).sum(1)

    if m.n_shared_experts:
        sp = p["shared"]
        xf = x.reshape(t, d)
        y = y + (F.silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])) @ sp["w_down"]
    return y.reshape(b, s, d)
