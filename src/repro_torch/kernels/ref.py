"""Plain PyTorch versions of the ported kernels.

Each function repeats the arithmetic of its twin in ``repro/kernels/ref.py``
(f32 accumulation; the gather source of the ELL round may be a bf16
quantisation of the payload, decided by the caller). They are what
``ops`` runs for a tensor on the CPU, and what the CUDA kernels are held
against on the card. ``flash_attention_plain`` is the plain version of the
flash-attention kernel's own function (its masks, and zeros for a fully
masked row); ``flash_attention_ref`` is the reference's softmax oracle.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["gram_apply_ref", "batched_gram_apply_ref", "ell_spmm_ref",
           "ell_spmm_dense_ref", "ell_spmm_scan_ref", "batched_slab_tq_ref",
           "batched_slab_apply_ref", "grid_block_tq_ref",
           "grid_block_apply_ref", "gram_qr_ref", "flash_attention_ref",
           "flash_attention_plain"]

_NEG = -1e30        # the flash kernel's mask value


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def gram_apply_ref(x: torch.Tensor, q: torch.Tensor,
                   normalize: bool = True) -> torch.Tensor:
    """V = X (X^T Q) / n. x: (d, n) local data block, q: (d, r) -> (d, r)."""
    acc = _acc(x.dtype)
    xa = x.to(acc)
    v = xa @ (xa.mT @ q.to(acc))
    if normalize:
        v = v / x.shape[1]
    return v.to(q.dtype)


def batched_gram_apply_ref(x_stack: torch.Tensor, q_stack: torch.Tensor,
                           n_true: torch.Tensor) -> torch.Tensor:
    """V[i] = X_i (X_i^T Q_i) / n_i over stacked nodes.

    x_stack: (N, d, n) zero-padded blocks, q_stack: (N, d, r), n_true: (N,)
    real per-node sample counts for the normalizer.
    """
    acc = _acc(x_stack.dtype)
    xa = x_stack.to(acc)
    v = xa @ (xa.mT @ q_stack.to(acc))
    v = v / n_true.to(acc)[:, None, None]
    return v.to(q_stack.dtype)


def batched_slab_tq_ref(x_stack: torch.Tensor,
                        q_stack: torch.Tensor) -> torch.Tensor:
    """Z[i] = X_i^T Q_i over stacked feature slabs (F-DOT Alg. 2, step 1).

    x_stack: (N, d_max, n) zero-padded slabs, q_stack: (N, d_max, r) iterates
    padded with zero rows to match -> (N, n, r). The padded rows are null in
    both operands, so they add nothing.
    """
    acc = _acc(x_stack.dtype)
    return torch.einsum("idn,idr->inr", x_stack.to(acc),
                        q_stack.to(acc)).to(q_stack.dtype)


def batched_slab_apply_ref(x_stack: torch.Tensor,
                           s_stack: torch.Tensor) -> torch.Tensor:
    """V[i] = X_i S_i over stacked feature slabs (F-DOT Alg. 2, step 3).

    x_stack: (N, d_max, n), s_stack: (N, n, r) -> (N, d_max, r). Padded rows
    of X give zero rows of V.
    """
    acc = _acc(x_stack.dtype)
    return torch.einsum("idn,inr->idr", x_stack.to(acc),
                        s_stack.to(acc)).to(s_stack.dtype)


def grid_block_tq_ref(x_grid: torch.Tensor,
                      q_stack: torch.Tensor) -> torch.Tensor:
    """Z[i, j] = X_ij^T Q_i over an I x J grid of blocks (B-DOT stage 1).

    x_grid: (I, J, d_max, n_max) zero-padded blocks, q_stack: (I, d_max, r)
    row iterates -> (I, J, n_max, r). Q is indexed by the grid row.
    """
    acc = _acc(x_grid.dtype)
    return torch.einsum("ijdn,idr->ijnr", x_grid.to(acc),
                        q_stack.to(acc)).to(q_stack.dtype)


def grid_block_apply_ref(x_grid: torch.Tensor,
                         s_stack: torch.Tensor) -> torch.Tensor:
    """V[i, j] = X_ij S_j over an I x J grid of blocks (B-DOT stage 2).

    x_grid: (I, J, d_max, n_max), s_stack: (J, n_max, r) per-column sums
    -> (I, J, d_max, r). S is indexed by the grid column.
    """
    acc = _acc(x_grid.dtype)
    return torch.einsum("ijdn,jnr->ijdr", x_grid.to(acc),
                        s_stack.to(acc)).to(s_stack.dtype)


def gram_qr_ref(v: torch.Tensor) -> torch.Tensor:
    """G = V^T V in f32 (the oracle of the CholeskyQR Gram kernel).

    v: (..., d, r) -> (..., r, r) float32; bf16 is promoted first.
    """
    va = v.to(_acc(v.dtype))
    return (va.mT @ va).to(torch.float32)


def _diag_term(diag: torch.Tensor, z_own: torch.Tensor) -> torch.Tensor:
    return diag.float()[..., None] * z_own.float()


def _gather_rows(z_src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """z_src[idx] over rows, member by member for a batch: z_src ((B,) N,
    K), idx ((B,) N, ...) -> ((B,) N, ..., K)."""
    if z_src.dim() == 3:                              # (B, N, K) batch
        b = torch.arange(idx.shape[0], device=idx.device)
        return z_src[b.reshape(-1, *([1] * (idx.dim() - 1))), idx.long()]
    return z_src[idx.long()]


def ell_spmm_ref(ell_idx: torch.Tensor, ell_val: torch.Tensor,
                 diag: torch.Tensor, z_own: torch.Tensor,
                 z_src: torch.Tensor) -> torch.Tensor:
    """out[i] = diag[i] z_own[i] + sum_l val[i,l] z_src[idx[i,l]], f32.

    One (N, L, K) gather, then a slot contraction. Padded slots carry
    weight 0 and self-point, so no masking is needed. A leading batch axis
    on every operand ((B, N, L) slots, (B, N) diagonal, (B, N, K) payload)
    mixes each member over its own slots: the reference's ``jax.vmap`` over
    a stacked ``SparseW``.
    """
    msgs = _gather_rows(z_src, ell_idx).float()          # ((B,) N, L, K)
    return _diag_term(diag, z_own) + torch.einsum(
        "...nl,...nlk->...nk", ell_val.float(), msgs)


def ell_spmm_dense_ref(ell_idx: torch.Tensor, ell_val: torch.Tensor,
                       diag: torch.Tensor, z_own: torch.Tensor,
                       z_src: torch.Tensor) -> torch.Tensor:
    """Densifying twin: scatter the ELL slots to an ((B,) N, N)
    off-diagonal matrix and multiply. Padded slots add weight 0 on the
    diagonal."""
    n = diag.shape[-1]
    lead = tuple(diag.shape[:-1])
    rows = torch.arange(n, device=ell_idx.device)[:, None].expand(
        *ell_idx.shape)
    w_off = torch.zeros(lead + (n, n), dtype=torch.float32,
                        device=diag.device)
    index = (rows, ell_idx.long())
    if lead:
        index = (torch.arange(lead[0], device=ell_idx.device)[:, None, None]
                 .expand(*ell_idx.shape),) + index
    w_off.index_put_(index, ell_val.float(), accumulate=True)
    return _diag_term(diag, z_own) + w_off @ z_src.float()


def ell_spmm_scan_ref(ell_idx: torch.Tensor, ell_val: torch.Tensor,
                      diag: torch.Tensor, z_own: torch.Tensor,
                      z_src: torch.Tensor) -> torch.Tensor:
    """Slot-at-a-time twin: O(N K) peak memory instead of O(N L K)."""
    acc = _diag_term(diag, z_own)
    for slot in range(ell_idx.shape[-1]):
        acc = acc + (ell_val[..., slot].float()[..., None]
                     * _gather_rows(z_src, ell_idx[..., slot]).float())
    return acc


def _attn_mask(sq: int, skv: int, q_offset: int, kv_valid: int, causal: bool,
               window: Optional[int], device) -> torch.Tensor:
    """(sq, skv) bool: key kpos is visible to query row i at qpos = i +
    q_offset."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    mask = kpos < kv_valid
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Standard softmax attention oracle.

    q: (b, h, sq, hd), k/v: (b, h, skv, hd). Queries align to the end of the
    key stream. ``window``: attend to keys within [i - window + 1, i]. A
    fully masked row gives NaN, as the reference's oracle does.
    """
    hd = q.shape[-1]
    scale = (hd ** -0.5) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sq, skv = q.shape[2], k.shape[2]
    mask = _attn_mask(sq, skv, skv - sq, skv, causal, window, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def kv_group(hq: int, hkv: int, group: Optional[int] = None,
             q_head0: int = 0) -> int:
    """The query heads a kv head serves, ``group`` (default hq / hkv,
    which must divide), checked against a launch of ``hq`` query heads,
    the model's [q_head0, q_head0 + hq), given the ``hkv`` kv heads they
    read (``expand_kv``)."""
    if group is None:
        if hq % hkv:
            raise ValueError(f"query heads {hq} not a multiple of kv heads "
                             f"{hkv}")
        group = max(hq // hkv, 1)
    if group < 1 or q_head0 < 0 or (
            hq and (q_head0 + hq - 1) // group - q_head0 // group >= hkv):
        raise ValueError(f"query heads [{q_head0}, {q_head0 + hq}) in "
                         f"groups of {group} read more than the {hkv} kv "
                         f"heads given")
    return group


def expand_kv(t: torch.Tensor, hq: int, group: int,
              q_head0: int = 0) -> torch.Tensor:
    """The kv heads ``t`` (b, hkv, s, hd) given to a launch of ``hq`` query
    heads, the model's [q_head0, q_head0 + hq), one a query head: head i
    takes the model's kv head (q_head0 + i) // group, the first of ``t``
    being q_head0 // group's. ``repeat_interleave`` (the twin of the
    reference's ``jnp.repeat``; not ``Tensor.repeat``, which would pair h
    with h % hkv), then the launch's heads: the gradient is summed as
    ``repeat_interleave``'s (an index gather's would add with atomics on
    the card, in the gradient's dtype)."""
    return t.repeat_interleave(group, dim=1).narrow(
        1, q_head0 % group if hq else 0, hq)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None, q_offset: int = 0,
                          kv_valid: Optional[int] = None,
                          group: Optional[int] = None,
                          q_head0: int = 0) -> torch.Tensor:
    """What the flash-attention kernel computes, in one pass.

    q: (b, hq, sq, hd), k/v: (b, hkv, skv, hd), as the kernel takes them:
    query head i reads kv head (q_head0 + i) // group - q_head0 // group
    (by default h // (hq // hkv), hq % hkv == 0), here through
    ``expand_kv``. Row i sits at qpos = i + q_offset; keys at kpos >=
    kv_valid are masked. f32 logits and P V; masked logits are -1e30 and
    their p is 0; a row with no visible key emits zeros (the kernel's l ==
    0 -> 1). Output in q's dtype.
    """
    hq, hd = q.shape[1], q.shape[-1]
    hkv, skv = k.shape[1], k.shape[2]
    group = kv_group(hq, hkv, group, q_head0)
    k = expand_kv(k, hq, group, q_head0)
    v = expand_kv(v, hq, group, q_head0)
    scale = (hd ** -0.5) if scale is None else scale
    kv_valid = skv if kv_valid is None else kv_valid
    mask = _attn_mask(q.shape[2], skv, q_offset, kv_valid, causal, window,
                      q.device)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    logits = logits.masked_fill(~mask, _NEG)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m).masked_fill(~mask, 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l).to(q.dtype)
