"""Plain PyTorch versions of the ported kernels.

Each function repeats the arithmetic of its twin in ``repro/kernels/ref.py``
(f32 accumulation; the gather source of the ELL round may be a bf16
quantisation of the payload, decided by the caller). They are what
``ops`` runs for a tensor on the CPU, and what the CUDA kernels are held
against on the card.
"""
from __future__ import annotations

import torch

__all__ = ["gram_apply_ref", "batched_gram_apply_ref", "ell_spmm_ref",
           "ell_spmm_dense_ref", "ell_spmm_scan_ref", "batched_slab_tq_ref",
           "batched_slab_apply_ref", "grid_block_tq_ref",
           "grid_block_apply_ref"]


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


def _diag_term(diag: torch.Tensor, z_own: torch.Tensor) -> torch.Tensor:
    return diag.float()[:, None] * z_own.float()


def ell_spmm_ref(ell_idx: torch.Tensor, ell_val: torch.Tensor,
                 diag: torch.Tensor, z_own: torch.Tensor,
                 z_src: torch.Tensor) -> torch.Tensor:
    """out[i] = diag[i] z_own[i] + sum_l val[i,l] z_src[idx[i,l]], f32.

    One (N, L, K) gather, then a slot contraction. Padded slots carry
    weight 0 and self-point, so no masking is needed.
    """
    msgs = z_src[ell_idx.long()].float()                     # (N, L, K)
    return _diag_term(diag, z_own) + torch.einsum(
        "nl,nlk->nk", ell_val.float(), msgs)


def ell_spmm_dense_ref(ell_idx: torch.Tensor, ell_val: torch.Tensor,
                       diag: torch.Tensor, z_own: torch.Tensor,
                       z_src: torch.Tensor) -> torch.Tensor:
    """Densifying twin: scatter the ELL slots to an (N, N) off-diagonal
    matrix and multiply. Padded slots add weight 0 on the diagonal."""
    n = diag.shape[0]
    rows = torch.arange(n, device=ell_idx.device)[:, None].expand_as(ell_idx)
    w_off = torch.zeros((n, n), dtype=torch.float32, device=diag.device)
    w_off.index_put_((rows, ell_idx.long()), ell_val.float(), accumulate=True)
    return _diag_term(diag, z_own) + w_off @ z_src.float()


def ell_spmm_scan_ref(ell_idx: torch.Tensor, ell_val: torch.Tensor,
                      diag: torch.Tensor, z_own: torch.Tensor,
                      z_src: torch.Tensor) -> torch.Tensor:
    """Slot-at-a-time twin: O(N K) peak memory instead of O(N L K)."""
    acc = _diag_term(diag, z_own)
    idx = ell_idx.long()
    for slot in range(ell_idx.shape[1]):
        acc = acc + ell_val[:, slot].float()[:, None] * z_src[idx[:, slot]].float()
    return acc
