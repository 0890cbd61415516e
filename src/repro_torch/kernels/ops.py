"""Dispatch for the ported kernels: the twin of ``repro/kernels/ops.py``.

A CUDA tensor goes to the hand-written Hopper kernel, and the call raises
if the kernel cannot take it; there is no fallback on the card. A CPU
tensor goes to the plain version in ``ref.py``, choosing the gather, scan
or densify form for the ELL round exactly as the reference's
``ell_spmm_path`` does, so CPU results follow the reference's own CPU path.

The reference's TPU guards (VMEM byte limits that fall back to the oracle,
padding the sample axis to a 512-column block, padding attention's
streams to 128 and the oracle below one block) do not carry over: the CUDA
kernels mask their own ragged edges and take any size.

``LAUNCHES`` counts the kernel launches of each wrapper, so a run can show
that its main path went through the kernels.

Lanes. A sweep runs L = cases x seeds copies of one family over the same
data. ``lane_slab_tq`` folds the lanes into the slab tq kernel's column
axis: the product is linear in the columns of Q, so g lanes of r columns
are one launch of g * r columns that reads X once, as many lanes a launch
as the kernel takes (``lane_fold_width``). ``lane_gram_apply`` and
``lane_slab_apply`` launch once a lane: on the H100 their folds lost (the
gram-apply kernel's wider instantiation keeps 4 x 32 values of Q and V a
thread; the slab-apply plan cuts X's rows into more chunks as the columns
grow, and each chunk reads all of S; PERF.md, tools/psa_kernel_variants.py
``--lane-fold``). The Gram kernel takes any leading batch, so
(lanes, N, d, r) is already one launch of ``gram_qr``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from . import ref

__all__ = ["LAUNCHES", "reset_launches", "on_gpu",
           "gram_apply", "batched_gram_apply", "batched_slab_tq",
           "batched_slab_apply", "lane_fold_width", "lane_gram_apply",
           "lane_slab_tq", "lane_slab_apply",
           "grid_block_tq", "grid_block_apply", "gram_qr", "ell_spmm",
           "ell_spmm_path", "ell_densify_wins", "flash_attention"]

LAUNCHES: Dict[str, int] = {"gram_apply": 0, "batched_gram_apply": 0,
                            "batched_slab_tq": 0, "batched_slab_apply": 0,
                            "grid_block_tq": 0, "grid_block_apply": 0,
                            "gram_qr": 0, "ell_spmm": 0,
                            "flash_attention": 0}


def reset_launches() -> None:
    """Zero every wrapper's count, and the counts by route of the flash-
    attention, gram-apply, slab-apply, Gram and ELL kernels."""
    from . import ell_spmm, flash_attention, gram_qr, gram_update, slab_ops
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for module in (flash_attention, gram_update, slab_ops, gram_qr,
                   ell_spmm):
        module.reset_route_launches()


def on_gpu() -> bool:
    """The counterpart of the reference's ``on_tpu()``."""
    return torch.cuda.is_available()


@functools.lru_cache(maxsize=64)
def _sample_count(device: torch.device, n: int) -> torch.Tensor:
    """(1,) f32 [n] on the card, made once: the kernel only reads it."""
    return torch.full((1,), float(n), dtype=torch.float32, device=device)


def gram_apply(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """V = X (X^T Q) / n. x: (d, n), q: (d, r) -> (d, r)."""
    if not x.is_cuda:
        return ref.gram_apply_ref(x, q)
    from .gram_update import batched_gram_apply_cuda
    v = batched_gram_apply_cuda(x.contiguous()[None], q.contiguous()[None],
                                _sample_count(x.device, x.shape[1]))[0]
    LAUNCHES["gram_apply"] += 1
    return v


def batched_gram_apply(x_stack: torch.Tensor, q_stack: torch.Tensor,
                       n_true: torch.Tensor) -> torch.Tensor:
    """V[i] = X_i (X_i^T Q_i) / n_i — Step 5 of Alg. 1 for all nodes at once.

    x_stack: (N, d, n) zero-padded blocks, q_stack: (N, d, r), n_true: (N,)
    true per-node sample counts.
    """
    if not x_stack.is_cuda:
        return ref.batched_gram_apply_ref(x_stack, q_stack, n_true)
    from .gram_update import batched_gram_apply_cuda
    v = batched_gram_apply_cuda(x_stack, q_stack.contiguous(), n_true)
    LAUNCHES["batched_gram_apply"] += 1
    return v


def batched_slab_tq(x_stack: torch.Tensor,
                    q_stack: torch.Tensor) -> torch.Tensor:
    """Z[i] = X_i^T Q_i — F-DOT step 1 for all nodes at once.

    x_stack: (N, d_max, n) zero-padded feature slabs, q_stack: (N, d_max, r)
    zero-row-padded iterates -> (N, n, r).
    """
    if not x_stack.is_cuda:
        return ref.batched_slab_tq_ref(x_stack, q_stack)
    from .slab_ops import slab_tq_cuda
    z = slab_tq_cuda(x_stack, q_stack.contiguous(), 1)
    LAUNCHES["batched_slab_tq"] += 1
    return z


def batched_slab_apply(x_stack: torch.Tensor,
                       s_stack: torch.Tensor) -> torch.Tensor:
    """V[i] = X_i S_i — F-DOT step 3 for all nodes at once.

    x_stack: (N, d_max, n), s_stack: (N, n, r) debiased consensus sums
    -> (N, d_max, r): the grid (I, J) = (1, N) of the apply kernel.
    """
    if not x_stack.is_cuda:
        return ref.batched_slab_apply_ref(x_stack, s_stack)
    from .slab_ops import slab_apply_cuda
    v = slab_apply_cuda(x_stack, s_stack.contiguous(), x_stack.shape[0])
    LAUNCHES["batched_slab_apply"] += 1
    return v


def lane_fold_width(lanes: int, r: int) -> int:
    """How many lanes of r columns one launch of the slab tq kernel takes:
    the most, up to ``lanes``, whose g * r columns the kernel instantiates
    (r = 7: 9 lanes). Pure: no card needed."""
    from .slab_ops import MAX_R
    if not 1 <= r <= MAX_R:
        raise ValueError(f"slab-tq kernel takes 1 <= r <= {MAX_R}, got {r}")
    return max(1, min(lanes, MAX_R // r))


def lane_gram_apply(x_stack: torch.Tensor, q_lanes: torch.Tensor,
                    n_true: torch.Tensor) -> torch.Tensor:
    """``batched_gram_apply`` for L lanes over one X, one launch a lane:
    x_stack (N, d, n), q_lanes (L, N, d, r) -> (L, N, d, r)."""
    return torch.stack([batched_gram_apply(x_stack, q, n_true)
                        for q in q_lanes])


def lane_slab_tq(x_stack: torch.Tensor,
                 q_lanes: torch.Tensor) -> torch.Tensor:
    """``batched_slab_tq`` for L lanes over one X, ``lane_fold_width``
    lanes a launch: x_stack (N, d_max, n), q_lanes (L, N, d_max, r)
    -> (L, N, n, r)."""
    if not x_stack.is_cuda:
        return torch.stack([ref.batched_slab_tq_ref(x_stack, q)
                            for q in q_lanes])
    from .slab_ops import slab_tq_cuda
    lanes, nodes, _, r = q_lanes.shape
    g = lane_fold_width(lanes, r)
    parts = []
    for a in range(0, lanes, g):
        y = q_lanes[a:a + g]                       # (g', N, d_max, r)
        folded = y.permute(1, 2, 0, 3).reshape(nodes, y.shape[2], -1)
        z = slab_tq_cuda(x_stack, folded.contiguous(), 1)   # (N, n, g' r)
        LAUNCHES["batched_slab_tq"] += 1
        parts.append(z.reshape(nodes, z.shape[1], y.shape[0], r)
                     .permute(2, 0, 1, 3))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def lane_slab_apply(x_stack: torch.Tensor,
                    s_lanes: torch.Tensor) -> torch.Tensor:
    """``batched_slab_apply`` for L lanes over one X, one launch a lane:
    x_stack (N, d_max, n), s_lanes (L, N, n, r) -> (L, N, d_max, r)."""
    return torch.stack([batched_slab_apply(x_stack, s) for s in s_lanes])


def grid_block_tq(x_grid: torch.Tensor, q_stack: torch.Tensor) -> torch.Tensor:
    """Z[i, j] = X_ij^T Q_i — B-DOT stage 1 for the whole grid.

    x_grid: (I, J, d_max, n_max) zero-padded blocks, q_stack: (I, d_max, r)
    row iterates -> (I, J, n_max, r).
    """
    if not x_grid.is_cuda:
        return ref.grid_block_tq_ref(x_grid, q_stack)
    from .slab_ops import slab_tq_cuda
    i_rows, j_cols, d, n = x_grid.shape
    z = slab_tq_cuda(x_grid.reshape(i_rows * j_cols, d, n),
                     q_stack.contiguous(), j_cols)
    LAUNCHES["grid_block_tq"] += 1
    return z.reshape(i_rows, j_cols, n, q_stack.shape[-1])


def grid_block_apply(x_grid: torch.Tensor,
                     s_stack: torch.Tensor) -> torch.Tensor:
    """V[i, j] = X_ij S_j — B-DOT stage 2 for the whole grid.

    x_grid: (I, J, d_max, n_max), s_stack: (J, n_max, r) per-column sums
    -> (I, J, d_max, r).
    """
    if not x_grid.is_cuda:
        return ref.grid_block_apply_ref(x_grid, s_stack)
    from .slab_ops import slab_apply_cuda
    i_rows, j_cols, d, n = x_grid.shape
    v = slab_apply_cuda(x_grid.reshape(i_rows * j_cols, d, n),
                        s_stack.contiguous(), j_cols)
    LAUNCHES["grid_block_apply"] += 1
    return v.reshape(i_rows, j_cols, d, s_stack.shape[-1])


def gram_qr(v: torch.Tensor) -> torch.Tensor:
    """G = V^T V — the Gram of every CholeskyQR pass, over any leading
    batch. v: (..., d, r) f32 or bf16 -> (..., r, r) f32, exactly symmetric
    on the card.

    All matrices of the batch go through one launch (bf16 on the tensor
    cores where r is a multiple of 8 above 16). The reference's guard
    (d below one block -> oracle) and its padding of d do not carry over:
    the kernel masks its own ragged d.
    """
    if not v.is_cuda:
        return ref.gram_qr_ref(v)
    if v.dim() < 2:
        raise ValueError(f"gram_qr takes (..., d, r), got {tuple(v.shape)}")
    from .gram_qr import gram_qr_cuda
    d, r = v.shape[-2:]
    g = gram_qr_cuda(v.reshape(-1, d, r).contiguous())
    LAUNCHES["gram_qr"] += 1
    return g.reshape(*v.shape[:-2], r, r)


# Above this many gathered message elements (N * L * K) the one-shot
# gather's (N, L, K) intermediate is traded for the slot-at-a-time scan.
_ELL_GATHER_ELEMS = 1 << 25

# The reference's CPU crossover: past L ~ N / _ELL_DENSE_RATIO the gather
# loses to scatter-to-dense + matmul on the CPU.
_ELL_DENSE_RATIO = 11


def ell_densify_wins(n: int, ell_width: int) -> bool:
    """For this (N, L) the densified matmul beats the CPU gather/scan
    forms, so a CPU ``SparseW`` mixes through a cached dense mirror."""
    return ell_width * _ELL_DENSE_RATIO >= n


def ell_spmm_path(n: int, ell_width: int, k: int,
                  use_kernel: Optional[bool] = None) -> str:
    """Which path ``ell_spmm`` takes for these shapes: 'cuda' |
    'fallback_gather' | 'fallback_scan' | 'fallback_dense'.

    'cuda' (the reference's 'pallas') whenever the payload is on the card,
    with no size guard; the three plain forms are CPU-only.
    """
    if use_kernel is None:
        use_kernel = on_gpu()
    if use_kernel:
        return "cuda"
    if ell_densify_wins(n, ell_width):
        return "fallback_dense"
    if n * ell_width * k <= _ELL_GATHER_ELEMS:
        return "fallback_gather"
    return "fallback_scan"


_CPU_PATHS = {"fallback_gather": ref.ell_spmm_ref,
              "fallback_dense": ref.ell_spmm_dense_ref,
              "fallback_scan": ref.ell_spmm_scan_ref}


def ell_spmm(ell_idx: torch.Tensor, ell_val: torch.Tensor,
             diag: torch.Tensor, z: torch.Tensor, *,
             payload_dtype: Optional[str] = None,
             window=None) -> torch.Tensor:
    """One sparse gossip round: out[i] = diag[i] z[i] + sum_l val[i,l]
    z[idx[i,l]]. ell_idx/ell_val: (N, L), diag: (N,), z: (N, K) -> (N, K) f32.

    A stack of B sub-networks (a stacked ``SparseW``: ell_idx / ell_val
    (B, N, L), diag (B, N), z (B, N, K) -> (B, N, K)) mixes each member over
    its own slots: on the card one launch for all B (one count in
    ``LAUNCHES["ell_spmm"]``), on the CPU the plain forms with the same
    batch axis, each chosen by one member's shapes as the reference's
    vmapped round chooses it.

    ``payload_dtype`` (e.g. "bfloat16") quantises the gather source, the
    neighbour messages, before the f32 accumulation; each node's own
    diagonal term stays full precision. On the card the kernel rounds each
    message itself (one launch a round; bf16 is the payload type it
    takes), and ``window``, which the card needs, is the graph's
    shared-memory staging (``SparseW.window``, an ``ell_spmm.WindowPlan``
    planned once from the host indices), which moves the time and never
    the bits; the CPU ignores it.
    """
    n, k = z.shape[-2:]
    if not z.is_cuda:
        z_src = (z if payload_dtype is None
                 else z.to(getattr(torch, payload_dtype)))
        path = ell_spmm_path(n, ell_idx.shape[-1], k, use_kernel=False)
        return _CPU_PATHS[path](ell_idx, ell_val, diag, z, z_src)
    from .ell_spmm import ell_spmm_cuda
    if payload_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"the ELL kernel takes f32 or bf16 payloads, got "
                         f"{payload_dtype}")
    if window is None:
        raise ValueError("the ELL kernel needs the graph's window "
                         "(SparseW.window)")
    out = ell_spmm_cuda(ell_idx, ell_val, diag, z.float().contiguous(),
                        window=window, quantise=payload_dtype == "bfloat16")
    LAUNCHES["ell_spmm"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    group: Optional[int] = None,
                    q_head0: int = 0) -> torch.Tensor:
    """GQA-aware attention. q: (b, hq, sq, hd); k/v: (b, hkv, skv, hd).
    Queries align to the end of the key stream (q_offset = skv - sq), so
    the same call serves prefill and a chunk of decode.

    Query head i is the model's q_head0 + i and reads the model's kv head
    (q_head0 + i) // ``group``, the first of k / v being q_head0 //
    group's (``ref.expand_kv``): a model rank's heads that straddle GQA
    groups. By default group = hq / hkv (hq % hkv == 0) and q_head0 = 0:
    head h reads kv head h // (hq / hkv).

    On the card the kernel reads that kv head in place; on the CPU the
    plain version reads the same head.
    """
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = ref.kv_group(hq, hkv, group, q_head0)
    scale = (hd ** -0.5) if scale is None else scale
    if not q.is_cuda:
        return ref.flash_attention_plain(
            q, k, v, causal=causal, window=window, scale=scale,
            q_offset=skv - sq, kv_valid=skv, group=group, q_head0=q_head0)
    from .flash_attention import flash_attention_cuda
    out = flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window, scale=scale,
                               q_offset=skv - sq, kv_valid=skv, group=group,
                               q_head0=q_head0)
    LAUNCHES["flash_attention"] += 1
    return out
