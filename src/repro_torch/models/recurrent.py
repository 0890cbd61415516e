"""Recurrent token mixers: xLSTM (mLSTM / sLSTM) and RG-LRU
(RecurrentGemma). The twin of ``repro/models/recurrent.py``.

Each has a full-sequence path and a one-token decode path over a fixed-size
state, with the reference's dtype choices on each (but RG-LRU's full
path, below):

* mLSTM, matrix-memory LSTM (gated linear attention), chunked: a Python
  loop over the ``s / mlstm_chunk`` chunks, within a chunk the
  decay-weighted quadratic form, across chunks the (hd x hd) state, every
  chunk's matrices in f32.
* sLSTM, scalar-memory LSTM with exponential gating and head
  block-diagonal recurrent weights: truly sequential, a Python loop over
  time of ``_slstm_cell`` (the input projection of every token is one
  matmul ahead of the loop; the recurrent one is a step's).
* RG-LRU, the gated diagonal linear recurrence of Griffin. The full path
  replaces the reference's ``lax.associative_scan`` with a Hillis-Steele
  scan: log2(s) elementwise doubling steps of the same combine
  (a1 a2, b1 a2 + b2). ``exp(cumsum(log a))`` is not used: log a reaches
  -8 softplus(8) ~ -64 a step, and its running sum over- and underflows.
  Both paths run the conv, the gates' products and the recurrence in f32
  (decode reverses the conv kernel). Here the full path departs from the
  reference, which convolves and takes the gates' products in the model
  dtype: in bf16 that put prefill 5e-2 (relative RMS of the logits) from
  the reference's own f32 decode at 26 layers, against 1.5e-2 with both in
  f32 (tools/rglru_decode_drift.py). In f32 models the two are the same.

No Pallas kernel of the reference is on these paths (XLA fuses them
there): their products are torch matmuls.

Split over "model" (``model=``, the "model" ``AxisGroup``): the weights are a
rank's blocks under ``models/sharding.param_specs``, the input the whole
(replicated) residual stream, the output this rank's partial sum of the
row-parallel output projection (f32, ``partial_product``), which the caller
reduces over "model". A rank computes its channels (RG-LRU) or whole heads
(mLSTM, sLSTM: its ``sharding.share``, the first n % tp ranks one more
where tp does not divide the heads, none where there are fewer heads than
ranks); the decode state is stored as ``decode_state_specs`` cuts it.
Where a stored block (a leaf's columns, a state's heads or channels) does
not line up with the rank's heads, ``launch/mesh.take_share`` gathers the
whole (``gather_summed_from_model``, its gradient summed over "model") and
keeps the rank's part, ``put_share`` regroups the rank's part back to the
block (a reduce-scatter, ``scatter_summed_to_model``) or, for a state kept
whole, to the whole (an f32 all-reduce); a per-head leaf kept whole is read
at the rank's heads (its gradient summed over "model"):

* RG-LRU: ``w_in`` / ``w_gate_in`` / ``w_out`` and the gates' columns
  are the rank's channels, ``conv_w`` and ``lam`` sliced to them; the
  gates read the whole conv output, gathered in f32 (b, s, d) a layer.
* mLSTM: ``w_up`` / ``w_gate`` / ``w_down`` hold a column (row) block
  of the channels, the rank's heads where they divide. ``u`` is
  regrouped to the rank's heads for ``w_q`` / ``w_k`` / ``w_v`` (its
  heads of them) and the scan, and the heads' output back to the block
  for the gate and ``w_down``. ``w_if``'s columns are cut [i | f], so the
  (up, 2h) weight is gathered, each rank contracts its own block's
  ``up`` rows and the partial gates are all-reduced (both ways: each rank
  reads its heads' columns of the sum).
* sLSTM: ``w_gates``' columns are cut gate-major (i, f | z, o at tp 2):
  each rank computes its stored columns and the (b, s, 4d) result is
  gathered; ``r_gates`` (its heads) and the time loop are head-local (no
  collective a token); the FFN gathers ``h`` (b, s, d) (regrouped to
  the block first where the heads do not divide), then its ``[gate |
  up]`` product likewise, and takes columns [r f / tp, (r + 1) f / tp) of
  both; ``w_ffn_down`` is row-parallel (or, where f does not divide, whole
  and read in part).

Each gathers activations, not weights, but for ``w_if``: at the card's
shapes a gathered activation is the smaller there (``PERF.md``).

Where ``d_model`` does not divide over "model" (``sharding.whole_mixers``),
RG-LRU and sLSTM are not split: ``param_specs`` keeps their channel leaves
whole, as the reference's does, and every rank runs the mixer whole on its
whole input and state (``models/transformer._whole``), called unsplit.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..launch.mesh import (copy_to_model, gather_summed_from_model,
                           partial_product, put_share, reduce_from_model,
                           share_of, split_axis, take_share)
from .layers import init_dense, normal

__all__ = [
    "init_mlstm", "apply_mlstm", "init_mlstm_state", "mlstm_heads",
    "init_slstm", "apply_slstm", "init_slstm_state",
    "init_rglru", "apply_rglru", "init_rglru_state", "linear_scan",
]


# ===========================================================================
# mLSTM
# ===========================================================================
MLSTM_HEAD_DIM = 128


def _mlstm_hd(cfg: ModelConfig) -> int:
    return min(MLSTM_HEAD_DIM, 2 * cfg.d_model)


def mlstm_heads(cfg: ModelConfig) -> int:
    return (2 * cfg.d_model) // _mlstm_hd(cfg)


def init_mlstm(gen: Optional[torch.Generator], cfg: ModelConfig,
               device: torch.device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    up = 2 * d
    h = mlstm_heads(cfg)
    hd = _mlstm_hd(cfg)
    dt = cfg.torch_dtype
    b_if = torch.cat([torch.zeros(h, device=device),
                      3.0 * torch.ones(h, device=device)]).to(dt)
    return {
        "w_up": init_dense(gen, d, up, dt, device),
        "w_gate": init_dense(gen, d, up, dt, device),
        # per-head block-diagonal projections: (h, hd, hd)
        "w_q": normal(gen, (h, hd, hd), hd ** -0.5, dt, device),
        "w_k": normal(gen, (h, hd, hd), hd ** -0.5, dt, device),
        "w_v": normal(gen, (h, hd, hd), hd ** -0.5, dt, device),
        "w_if": init_dense(gen, up, 2 * h, dt, device, scale=0.01),
        "b_if": b_if,
        "w_down": init_dense(gen, up, d, dt, device),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, n_layers: int,
                     device: torch.device,
                     tp: int = 1) -> Dict[str, torch.Tensor]:
    """The (c, n) state; ``tp``: a model rank's share of ``tp`` as
    ``decode_state_specs`` cuts it: h / tp heads where they divide, else
    every head."""
    h, hd = mlstm_heads(cfg), _mlstm_hd(cfg)
    h //= tp if h % tp == 0 else 1
    return {"c": torch.zeros((n_layers, batch, h, hd, hd), device=device),
            "n": torch.zeros((n_layers, batch, h, hd), device=device)}


def _mlstm_chunk_scan(q, k, v, li, lf, chunk: int):
    """Chunked gated linear attention. q, k, v: (b, h, s, hd); li, lf: log
    input / forget gates (b, h, s). Returns (out f32, final c, final n)."""
    b, h, s, hd = q.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the mLSTM "
                         f"chunk {chunk}")
    scale = hd ** -0.5
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))
    c_state = torch.zeros((b, h, hd, hd), device=q.device)
    n_state = torch.zeros((b, h, hd), device=q.device)
    outs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qb, kb, vb = (t[:, :, sl].float() for t in (q, k, v))
        lib, lfb = li[:, :, sl].float(), lf[:, :, sl].float()
        f_cum = torch.cumsum(lfb, dim=-1)        # log product of forgets
        f_tot = f_cum[..., -1:]
        # inter-chunk: q_t decayed by every forget up to t
        q_dec = qb * torch.exp(f_cum)[..., None] * scale
        inter = torch.einsum("bhld,bhde->bhle", q_dec, c_state)
        n_inter = torch.einsum("bhld,bhd->bhl", q_dec, n_state)
        # intra-chunk: A_ts = exp(F_t - F_s + i_s) (q_t . k_s), s <= t
        w = f_cum[..., :, None] - f_cum[..., None, :] + lib[..., None, :]
        w = w.masked_fill(~causal, float("-inf"))
        a = torch.exp(w) * torch.einsum("bhld,bhmd->bhlm", qb * scale, kb)
        a = a.masked_fill(~causal, 0.0)
        intra = torch.einsum("bhlm,bhmd->bhld", a, vb)
        # the normaliser: the signed row sums of a, as the decode path's q.n
        denom = (n_inter + a.sum(-1)).abs().clamp_min(1.0)
        outs.append((inter + intra) / denom[..., None])
        # state: C' = exp(F_L) C + sum_s exp(F_L - F_s + i_s) k_s v_s^T
        k_dec = kb * torch.exp(f_tot - f_cum + lib)[..., None]
        c_state = torch.exp(f_tot)[..., None] * c_state + torch.einsum(
            "bhld,bhle->bhde", k_dec, vb)
        n_state = torch.exp(f_tot) * n_state + k_dec.sum(dim=2)
    return torch.cat(outs, dim=2), c_state, n_state


def _mlstm_gates(p, u: torch.Tensor, heads, n_heads: int, model):
    """(b, s, 2h) input and forget gate pre-activations of the heads
    ``heads`` [start, stop) of ``n_heads``; split (``model``; ``u`` the
    rank's stored block of the channels), the sum over "model" of each
    rank's block's ``up`` rows of the gathered ``w_if`` (module
    docstring), its heads' columns and ``b_if``'s."""
    if not split_axis(model):
        return u @ p["w_if"] + p["b_if"]
    w_if = p["w_if"]
    if w_if.shape[-1] != 2 * n_heads:
        w_if = gather_summed_from_model(w_if, model, dim=-1)
    up_loc = u.shape[-1]
    rows = w_if[model.index * up_loc:(model.index + 1) * up_loc]
    whole = copy_to_model(reduce_from_model(
        partial_product(u, rows, model), model).to(u.dtype), model)
    h0, h1 = heads
    cols = torch.cat([torch.arange(h0, h1),
                      torch.arange(n_heads + h0, n_heads + h1)]).to(u.device)
    return whole.index_select(-1, cols) + p["b_if"].index_select(0, cols)


def apply_mlstm(p, x: torch.Tensor, cfg: ModelConfig, *,
                state: Optional[Dict[str, torch.Tensor]] = None,
                chunk: Optional[int] = None, model=None):
    """Full sequence (state None) or one-token decode (state = {"c", "n"}).
    ``model``: split over "model" (module docstring); the state is stored
    as ``decode_state_specs`` cuts it (the rank's heads, or every head
    where they do not divide). Returns (out, new_state)."""
    b, s, d = x.shape
    hd = _mlstm_hd(cfg)
    n_heads = mlstm_heads(cfg)
    heads = share_of(n_heads, model)
    h = heads[1] - heads[0]
    cols = (heads[0] * hd, heads[1] * hd)
    u_blk = x @ p["w_up"]               # the rank's block of the channels
    g = F.silu(x @ p["w_gate"])
    uh = take_share(u_blk, cols, 2 * d, model).reshape(b, s, h, hd)
    q, k, v = (torch.einsum("bshd,hde->bhse", uh,
                            take_share(p[w], heads, n_heads, model, dim=0))
               for w in ("w_q", "w_k", "w_v"))
    gates = _mlstm_gates(p, u_blk, heads, n_heads, model)       # (b, s, 2h)
    li = F.logsigmoid(gates[..., :h]).transpose(1, 2)           # (b, h, s)
    lf = F.logsigmoid(gates[..., h:]).transpose(1, 2)

    if state is None:
        out, c_fin, n_fin = _mlstm_chunk_scan(q, k, v, li, lf,
                                              chunk or cfg.mlstm_chunk)
        new_state = {"c": c_fin, "n": n_fin}
    else:
        # one token: C' = f C + i k v^T; out = (q.C') / max(|q.n'|, 1)
        c0, n0 = (take_share(state[key], heads, n_heads, model, dim=1)
                  for key in ("c", "n"))
        fi = torch.exp(lf[..., 0].float())[..., None, None]     # (b, h, 1, 1)
        ii = torch.exp(li[..., 0].float())[..., None, None]
        k0, v0 = k[:, :, 0].float(), v[:, :, 0].float()
        c_new = fi * c0 + ii * torch.einsum("bhd,bhe->bhde", k0, v0)
        n_new = fi[..., 0] * n0 + ii[..., 0] * k0
        qv = q[:, :, 0].float() * hd ** -0.5
        num = torch.einsum("bhd,bhde->bhe", qv, c_new)
        den = torch.einsum("bhd,bhd->bh", qv, n_new).abs().clamp_min(1.0)
        out = (num / den[..., None])[:, :, None, :]            # (b, h, 1, hd)
        new_state = {key: put_share(new, heads, n_heads, model, dim=1,
                                    whole=state[key].shape[1] == n_heads)
                     for key, new in (("c", c_new), ("n", n_new))}

    out = out.transpose(1, 2).reshape(b, s, h * hd).to(x.dtype)
    out = put_share(out, cols, 2 * d, model)     # to the block, as g
    return partial_product(out * g, p["w_down"], model), new_state


# ===========================================================================
# sLSTM
# ===========================================================================
SLSTM_HEAD_DIM = 128


def _slstm_hd(d: int) -> int:
    return min(SLSTM_HEAD_DIM, d)


def init_slstm(gen: Optional[torch.Generator], cfg: ModelConfig,
               device: torch.device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    dt = cfg.torch_dtype
    f_up = 4 * d // 3
    hd = _slstm_hd(d)
    nh = d // hd
    return {
        "w_gates": init_dense(gen, d, 4 * d, dt, device),      # i, f, z, o
        # recurrent connections, head block-diagonal
        "r_gates": normal(gen, (nh, hd, 4 * hd), 0.5 * hd ** -0.5, dt,
                          device),
        "b_gates": torch.zeros((4 * d,), dtype=dt, device=device),
        "w_ffn_up": init_dense(gen, d, 2 * f_up, dt, device),  # gated FFN
        "w_ffn_down": init_dense(gen, f_up, d, dt, device),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, n_layers: int,
                     device: torch.device,
                     tp: int = 1) -> Dict[str, torch.Tensor]:
    """The (c, n, h) state; ``tp``: a model rank's share of ``tp`` as
    ``decode_state_specs`` cuts it: d / tp channels where they divide (a
    block that may end mid-head), else every channel."""
    d = cfg.d_model
    shape = (n_layers, batch, d // tp if d % tp == 0 else d)
    return {key: torch.zeros(shape, device=device) for key in ("c", "n", "h")}


def _slstm_cell(r_gates: torch.Tensor, d: int, carry, gx: torch.Tensor,
                bias: torch.Tensor):
    """One step over ``d`` channels (the rank's heads when split, whose
    ``r_gates`` (h, hd, 4 hd) it takes). carry = (c, n, h) f32 (b, d);
    gx = x_t @ w_gates (b, 4d) in the model dtype, laid out (4, heads,
    hd); ``bias`` the same layout."""
    c, n, hprev = carry
    b = gx.shape[0]
    nh, hd = r_gates.shape[0], r_gates.shape[1]
    # the recurrent term, per head, laid out as (b, 4, h, hd)
    hh = hprev.to(gx.dtype).reshape(b, nh, hd)
    gr = torch.einsum("bhd,hde->bhe", hh, r_gates)            # (b, h, 4 hd)
    gr = gr.reshape(b, nh, 4, hd).transpose(1, 2).reshape(b, 4 * d)
    gates = (gx + gr + bias).float()
    i = torch.exp(gates[..., :d].clamp_max(8.0))             # exp input gate
    f = torch.sigmoid(gates[..., d:2 * d])
    z = torch.tanh(gates[..., 2 * d:3 * d])
    o = torch.sigmoid(gates[..., 3 * d:])
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / n_new.abs().clamp_min(1.0)
    return c_new, n_new, h_new


def apply_slstm(p, x: torch.Tensor, cfg: ModelConfig, *,
                state: Optional[Dict[str, torch.Tensor]] = None, model=None):
    """Full sequence (state None) or one-token decode (state = {"c", "n",
    "h"}). ``model``: split over "model" (module docstring); the state is
    stored as ``decode_state_specs`` cuts it (a block of d / tp channels,
    which may end mid-head). Returns (out, new_state)."""
    b, s, d = x.shape
    hd = _slstm_hd(d)
    n_heads = d // hd
    heads = share_of(n_heads, model)
    cols = (heads[0] * hd, heads[1] * hd)      # the rank's channels
    d_loc = cols[1] - cols[0]
    r_gates = take_share(p["r_gates"], heads, n_heads, model, dim=0)
    gx = x @ p["w_gates"]                                    # (b, s, 4d)
    bias = p["b_gates"]
    f_up = 4 * d // 3
    split = split_axis(model)
    if split:
        if gx.shape[-1] != 4 * d:
            gx = gather_summed_from_model(gx, model, dim=-1)
        gx = gx.unflatten(-1, (4, d))[..., cols[0]:cols[1]].flatten(-2)
        bias = bias.unflatten(-1, (4, d))[..., cols[0]:cols[1]].flatten(-2)
    if state is None:
        zeros = torch.zeros((b, d_loc), device=x.device)
        carry = (zeros, zeros, zeros)
        hs = []
        for t in range(s):
            carry = _slstm_cell(r_gates, d_loc, carry, gx[:, t], bias)
            hs.append(carry[2])
        h = torch.stack(hs, dim=1).to(x.dtype)
        new_state = {"c": carry[0], "n": carry[1], "h": carry[2]}
    else:
        carry = _slstm_cell(r_gates, d_loc, tuple(
            take_share(state[key], cols, d, model) for key in ("c", "n", "h")),
            gx[:, 0], bias)
        h = carry[2][:, None].to(x.dtype)
        new_state = {key: put_share(new, cols, d, model,
                                    whole=state[key].shape[-1] == d)
                     for key, new in zip(("c", "n", "h"), carry)}
    # small gated FFN (xLSTM post-up/down, factor 4/3)
    w_down = p["w_ffn_down"]
    if not split:
        u = h @ p["w_ffn_up"]
        return (F.silu(u[..., :f_up]) * u[..., f_up:]) @ w_down, new_state
    # h of every channel: the rank's heads regrouped to its block, gathered
    u = take_share(put_share(h, cols, d, model), (0, d), d, model) \
        @ p["w_ffn_up"]
    if u.shape[-1] != 2 * f_up:
        u = gather_summed_from_model(u, model, dim=-1)
    lo = model.index * f_up // model.size
    hi = (model.index + 1) * f_up // model.size
    if w_down.shape[0] == f_up:          # whole: this rank's rows of it
        w_down = w_down[lo:hi]
    out = partial_product(F.silu(u[..., lo:hi]) * u[..., f_up + lo:f_up + hi],
                          w_down, model)
    return out, new_state


# ===========================================================================
# RG-LRU (Griffin recurrent block)
# ===========================================================================
_RGLRU_C = 8.0


def init_rglru(gen: Optional[torch.Generator], cfg: ModelConfig,
               device: torch.device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    dt = cfg.torch_dtype
    return {
        "w_in": init_dense(gen, d, d, dt, device),        # recurrence branch
        "w_gate_in": init_dense(gen, d, d, dt, device),   # multiplicative one
        "conv_w": normal(gen, (4, d), 0.1, dt, device),
        "w_rgate": init_dense(gen, d, d, dt, device, scale=0.01),
        "w_igate": init_dense(gen, d, d, dt, device, scale=0.01),
        "lam": torch.full((d,), 8.0, device=device),      # softplus param, f32
        "w_out": init_dense(gen, d, d, dt, device),
    }


def init_rglru_state(cfg: ModelConfig, batch: int, n_layers: int,
                     device: torch.device,
                     tp: int = 1) -> Dict[str, torch.Tensor]:
    """The (h, conv) state; ``tp``: a model rank's channels of ``tp`` as
    ``decode_state_specs`` cuts them: d / tp where they divide, else every
    channel (the mixer then runs whole on every rank)."""
    d = cfg.d_model // tp if cfg.d_model % tp == 0 else cfg.d_model
    return {"h": torch.zeros((n_layers, batch, d), device=device),
            "conv": torch.zeros((n_layers, batch, 3, d), device=device)}


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                dim: int = 1) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along ``dim``: the inclusive
    scan of the combine (a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2) in
    ceil(log2(s)) Hillis-Steele doubling steps, each elementwise over the
    whole sequence."""
    s = a.shape[dim]
    shift = 1
    while shift < s:
        a_lo, a_hi = a.narrow(dim, 0, s - shift), a.narrow(dim, shift,
                                                          s - shift)
        b_lo, b_hi = b.narrow(dim, 0, s - shift), b.narrow(dim, shift,
                                                          s - shift)
        b = torch.cat([b.narrow(dim, 0, shift), b_lo * a_hi + b_hi], dim)
        a = torch.cat([a.narrow(dim, 0, shift), a_lo * a_hi], dim)
        shift *= 2
    return b


def apply_rglru(p, x: torch.Tensor, cfg: ModelConfig, *,
                state: Optional[Dict[str, torch.Tensor]] = None, model=None):
    """Full sequence (state None) or one-token decode (state = {"h",
    "conv"}). ``model``: split over "model" (module docstring); the state
    holds the rank's channels. Returns (out, new_state)."""
    b, s, d = x.shape
    u = x @ p["w_in"]
    gate = F.gelu(x @ p["w_gate_in"], approximate="tanh")   # jax.nn.gelu's
    conv_w, lam = p["conv_w"], p["lam"]
    if split_axis(model):               # the rank's channels
        c0 = model.index * u.shape[-1]
        conv_w = conv_w[:, c0:c0 + u.shape[-1]]
        lam = lam[c0:c0 + u.shape[-1]]

    if state is None:
        # causal temporal conv of width 4 as shifted adds, in f32 as decode
        uf = u.float()
        pads = F.pad(uf, (0, 0, 3, 0))
        conv_w = conv_w.float()
        conv = sum(pads[:, 3 - i:s + 3 - i] * conv_w[i] for i in range(4))
        # the gates read every channel: the whole conv when split
        whole = gather_summed_from_model(conv, model, dim=-1)
        r = torch.sigmoid(whole @ p["w_rgate"].float())
        i_g = torch.sigmoid(whole @ p["w_igate"].float())
        log_a = -_RGLRU_C * r * F.softplus(lam)               # (b, s, d)
        beta = torch.sqrt((1.0 - torch.exp(2.0 * log_a)).clamp_min(1e-6))
        h = linear_scan(torch.exp(log_a), beta * (i_g * conv))
        conv_state = uf[:, -3:] if s >= 3 else F.pad(uf, (0, 0, 3 - s, 0))
        new_state = {"h": h[:, -1], "conv": conv_state}
        out = h.to(x.dtype)
    else:
        conv_buf = torch.cat([state["conv"], u[:, 0:1].float()], dim=1)
        # the buffer runs oldest to newest and conv_w[i] weights the token i
        # steps back, so the newest entry takes conv_w[0]: reverse the kernel
        conv = (conv_buf * conv_w.flip(0).float()).sum(dim=1)
        whole = gather_summed_from_model(conv, model, dim=-1)
        r = torch.sigmoid(whole @ p["w_rgate"].float())
        i_g = torch.sigmoid(whole @ p["w_igate"].float())
        log_a = -_RGLRU_C * r * F.softplus(lam)
        beta = torch.sqrt((1.0 - torch.exp(2.0 * log_a)).clamp_min(1e-6))
        h_new = torch.exp(log_a) * state["h"] + beta * (i_g * conv)
        new_state = {"h": h_new, "conv": conv_buf[:, 1:]}
        out = h_new[:, None].to(x.dtype)

    return partial_product(out * gate, p["w_out"], model), new_state
