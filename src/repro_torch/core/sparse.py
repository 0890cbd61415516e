"""Sparse mixing weights for large gossip networks (padded ELL + CSR).

The twin of ``repro/core/sparse.py``. At the 1k-10k-node scale the overlay
topologies have O(N) edges, so the (N, N) mixing matrix is >99% zeros.
``SparseW`` stores only the nonzero structure:

* padded ELL form, ``ell_idx``/``ell_val``: (N, L) with L the max row
  degree; slot (i, l) holds node i's l-th neighbour (ascending index), and
  slots past ``row_nnz[i]`` self-point with weight 0. The diagonal is a
  separate (N,) vector.
* a CSR view (``csr()``) and a dense round trip (``to_dense()``) on the host.

One gossip round is ``mix(z)``: the Hopper ELL kernel for a payload on the
card, the reference's CPU forms otherwise (``kernels/ops.ell_spmm``).

``payload_dtype="bfloat16"`` quantises neighbour messages to bf16 before
the f32 accumulation; each node's own state stays full precision.

``SparseW.stack`` stacks B same-N matrices into one (B, N, L) SparseW,
B-DOT's batched sub-networks (the reference's ``jax.vmap`` over a stacked
SparseW): its ``mix`` takes a (B, N, ...) payload, one ELL launch for all
B members, and ``st[k]`` is member k (widened to the common L).

Symmetry is required and checked: the debias recursion uses W^T = W.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..kernels import ops as kops
from ..kernels.ell_spmm import WindowPlan, window_plan

__all__ = ["SparseW", "auto_sparse", "AUTO_MIN_NODES", "AUTO_MAX_DENSITY"]

# DenseConsensus(sparse=None) turns sparse mixing on only above the network
# sizes of the paper's tables, so every N <= 200 result stays dense.
AUTO_MIN_NODES = 256
AUTO_MAX_DENSITY = 0.05
_ENV_FLAG = "REPRO_SPARSE_GOSSIP"


def auto_sparse(n_nodes: int, density: float,
                sparse: Optional[bool] = None) -> bool:
    """Resolve the engine-level ``sparse`` tri-state.

    ``True``/``False`` are explicit; ``None`` turns sparse mixing on when the
    network is both large (>= AUTO_MIN_NODES) and sparse (<= AUTO_MAX_DENSITY).
    ``REPRO_SPARSE_GOSSIP=0`` or ``=1`` overrides the auto rule (explicit
    arguments still win).
    """
    if sparse is not None:
        return bool(sparse)
    env = os.environ.get(_ENV_FLAG, "").strip().lower()
    if env in ("0", "false", "off"):
        return False
    if env in ("1", "true", "on"):
        return True
    return n_nodes >= AUTO_MIN_NODES and density <= AUTO_MAX_DENSITY


class SparseW:
    """Symmetric doubly-stochastic mixing matrix in padded-ELL form; with
    a leading batch axis on every tensor, a ``stack`` of B of them."""

    def __init__(self, ell_idx: torch.Tensor, ell_val: torch.Tensor,
                 diag: torch.Tensor, row_nnz: torch.Tensor, n: int,
                 ell_width: int, payload_dtype: Optional[str] = None,
                 dense_off: Optional[torch.Tensor] = None,
                 window: Optional[WindowPlan] = None,
                 member_windows: Optional[Tuple[WindowPlan, ...]] = None):
        self.ell_idx = ell_idx          # ((B,) N, L) int32, self past row_nnz
        self.ell_val = ell_val          # ((B,) N, L) weights, 0 past row_nnz
        self.diag = diag                # ((B,) N)
        self.row_nnz = row_nnz          # ((B,) N) int32
        self.n = int(n)
        self.ell_width = int(ell_width)
        self.payload_dtype = payload_dtype
        # (N, N) f32 off-diagonal mirror: only for a CPU SparseW past the
        # CPU crossover (ops.ell_densify_wins). On the card every round
        # goes through the ELL kernel.
        self.dense_off = dense_off
        # the ELL kernel's shared-memory window (band and halo), from the
        # host indices once, so that no round asks the card about the graph;
        # a stack has one for its batched launch and one a member, which
        # indexing hands on
        host = None
        if window is None:
            host = ell_idx.cpu().numpy()
            window = window_plan(host)
        self.window = window
        if ell_idx.dim() == 3 and member_windows is None:
            host = ell_idx.cpu().numpy() if host is None else host
            member_windows = tuple(window_plan(h) for h in host)
        self.member_windows = member_windows

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_dense(cls, w: np.ndarray, adjacency: Optional[np.ndarray] = None,
                   *, payload_dtype: Optional[str] = None,
                   device: DeviceLike = None) -> "SparseW":
        """Build from a host (N, N) symmetric weight matrix.

        ``adjacency`` fixes the stored structure (a real edge is kept even
        if its weight is 0); without it the structure is the nonzero
        off-diagonal pattern of ``w``.
        """
        dev = resolve_device(device)
        w = np.asarray(w, np.float64)
        n = int(w.shape[0])
        if w.shape != (n, n):
            raise ValueError(f"w must be square, got {w.shape}")
        if not np.allclose(w, w.T, atol=1e-12):
            raise ValueError("SparseW requires a symmetric weight matrix "
                             "(the debias recursion uses W^T = W)")
        struct = np.asarray(adjacency) > 0 if adjacency is not None else w != 0
        struct = np.array(struct, bool, copy=True)
        np.fill_diagonal(struct, False)
        struct |= struct.T
        row_nnz = struct.sum(axis=1).astype(np.int32)
        ell_width = max(int(row_nnz.max(initial=0)), 1)
        rows, cols = np.nonzero(struct)   # row-major: ascending neighbours
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(row_nnz, out=indptr[1:])
        slots = np.arange(rows.size) - indptr[rows]
        ell_idx = np.tile(np.arange(n, dtype=np.int32)[:, None],
                          (1, ell_width))
        ell_val = np.zeros((n, ell_width), np.float32)
        ell_idx[rows, slots] = cols.astype(np.int32)
        ell_val[rows, slots] = w[rows, cols].astype(np.float32)
        dense_off = None
        if dev.type == "cpu" and kops.ell_densify_wins(n, ell_width):
            off = w.astype(np.float32).copy()
            np.fill_diagonal(off, 0.0)
            dense_off = torch.from_numpy(off)
        return cls(torch.from_numpy(ell_idx).to(dev),
                   torch.from_numpy(ell_val).to(dev),
                   torch.from_numpy(np.diagonal(w).astype(np.float32)).to(dev),
                   torch.from_numpy(row_nnz).to(dev), n, ell_width,
                   payload_dtype, dense_off)

    @classmethod
    def from_graph(cls, graph, weights: Optional[np.ndarray] = None, *,
                   payload_dtype: Optional[str] = None,
                   device: DeviceLike = None) -> "SparseW":
        """Build from a ``topology.Graph`` (default: local-degree weights)."""
        if weights is None:
            from .topology import local_degree_weights
            weights = local_degree_weights(graph)
        return cls.from_dense(weights, graph.adjacency,
                              payload_dtype=payload_dtype, device=device)

    @classmethod
    def stack(cls, sws: Sequence["SparseW"]) -> "SparseW":
        """Stack same-N matrices into one batched SparseW (a leading axis on
        every tensor), padding ELL widths to the common max with
        self-pointing, zero-weight slots: the sparse twin of stacking B
        dense (N, N) weights, which B-DOT's batched gossip stages use.

        The batched launch's window is planned once from every member's
        host indices, and so is each member's own (a member already at the
        common width keeps its plan): indexing hands them on, so no round
        re-plans or asks the card about the graph. A CPU stack past the
        densify crossover at the common width carries every member's dense
        mirror.
        """
        sws = list(sws)
        n, pd, dev = sws[0].n, sws[0].payload_dtype, sws[0].device
        if any(s.n != n or s.payload_dtype != pd for s in sws):
            raise ValueError("stack needs matching n and payload_dtype")
        if any(s.batch is not None or s.device != dev for s in sws):
            raise ValueError("stack takes unstacked SparseW on one device")
        width = max(s.ell_width for s in sws)

        def widen(s: "SparseW"):
            extra = width - s.ell_width
            if extra == 0:
                return s.ell_idx, s.ell_val
            selfp = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
            return (torch.cat([s.ell_idx, selfp.expand(n, extra)], dim=1),
                    F.pad(s.ell_val, (0, extra)))

        idx, val = zip(*(widen(s) for s in sws))
        idx = torch.stack(idx)
        host = idx.cpu().numpy()
        dense_off = None
        if dev.type == "cpu" and kops.ell_densify_wins(n, width):
            dense_off = torch.stack([s.dense_off if s.dense_off is not None
                                     else s._scatter_off() for s in sws])
        return cls(idx, torch.stack(val), torch.stack([s.diag for s in sws]),
                   torch.stack([s.row_nnz for s in sws]), n, width, pd,
                   dense_off, window_plan(host),
                   tuple(s.window if s.ell_width == width else window_plan(h)
                         for s, h in zip(sws, host)))

    def __getitem__(self, k: int) -> "SparseW":
        """Member k of a ``stack`` (widened to the stack's L), with the
        window planned for it at ``stack``."""
        if self.batch is None:
            raise TypeError("only a stacked SparseW can be indexed")
        k = int(k)
        off = None if self.dense_off is None else self.dense_off[k]
        return SparseW(self.ell_idx[k], self.ell_val[k], self.diag[k],
                       self.row_nnz[k], self.n, self.ell_width,
                       self.payload_dtype, off, self.member_windows[k])

    # -- array-protocol shims (the surface consensus.py relies on) ----------
    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def batch(self) -> Optional[int]:
        """B for a stack of B matrices, else None."""
        return self.ell_idx.shape[0] if self.ell_idx.dim() == 3 else None

    @property
    def device(self) -> torch.device:
        return self.ell_val.device

    @property
    def dtype(self) -> torch.dtype:
        return self.ell_val.dtype

    def _replace(self, **kw) -> "SparseW":
        fields = dict(ell_idx=self.ell_idx, ell_val=self.ell_val,
                      diag=self.diag, row_nnz=self.row_nnz, n=self.n,
                      ell_width=self.ell_width,
                      payload_dtype=self.payload_dtype,
                      dense_off=self.dense_off, window=self.window,
                      member_windows=self.member_windows)
        fields.update(kw)
        return SparseW(**fields)

    def astype(self, dtype: torch.dtype) -> "SparseW":
        """Cast the stored weights (structure and window plans untouched)."""
        if dtype == self.ell_val.dtype:
            return self
        return self._replace(ell_val=self.ell_val.to(dtype),
                             diag=self.diag.to(dtype))

    def with_payload_dtype(self, payload_dtype: Optional[str]) -> "SparseW":
        return self._replace(payload_dtype=payload_dtype)

    def _scatter_off(self) -> torch.Tensor:
        """The (N, N) f32 off-diagonal matrix of the ELL slots (padded slots
        self-point with weight 0, so the scatter-add is exact)."""
        rows = torch.arange(self.n, device=self.device)[:, None].expand(
            self.n, self.ell_width)
        off = torch.zeros((self.n, self.n), dtype=torch.float32,
                          device=self.device)
        off.index_put_((rows, self.ell_idx.long()), self.ell_val.float(),
                       accumulate=True)
        return off

    @property
    def T(self) -> "SparseW":
        """W^T == W: symmetry is enforced at construction."""
        return self

    # -- the gossip round ---------------------------------------------------
    def _flat(self, z: torch.Tensor) -> torch.Tensor:
        """A payload ((B,) N, ...) as ((B,) N, K)."""
        return z.reshape(*self.ell_idx.shape[:-2], self.n, -1)

    def mix(self, z: torch.Tensor) -> torch.Tensor:
        """One gossip application ``out_i = diag_i z_i + sum_l val_il
        z_{idx_il}`` over a payload z: (N, ...), or (B, N, ...) for a stack
        (each member mixes its own slice), f32 accumulation."""
        zf = self._flat(z)
        if self.dense_off is not None:
            z_src = (zf if self.payload_dtype is None
                     else zf.to(getattr(torch, self.payload_dtype)))
            out = (self.diag.float()[..., None] * zf.float()
                   + self.dense_off @ z_src.float())
        else:
            out = kops.ell_spmm(self.ell_idx, self.ell_val, self.diag, zf,
                                payload_dtype=self.payload_dtype,
                                window=self.window)
        return out.to(z.dtype).reshape(z.shape)

    def offdiag_mix(self, diag: torch.Tensor, val: torch.Tensor,
                    z: torch.Tensor) -> torch.Tensor:
        """Mixing round with overridden per-round diagonal and slot values
        (same structure), the hook of the fault models."""
        zf = self._flat(z)
        out = kops.ell_spmm(self.ell_idx, val, diag, zf,
                            payload_dtype=self.payload_dtype,
                            window=self.window)
        return out.to(z.dtype).reshape(z.shape)

    def mix_host(self, x: np.ndarray) -> np.ndarray:
        """NumPy matvec/matmat (host), O(nnz): the oracle for power-iteration
        spectral estimates without materializing the dense matrix."""
        x = np.asarray(x)
        idx = self.ell_idx.cpu().numpy()
        val = self.ell_val.cpu().numpy()
        diag = self.diag.cpu().numpy()
        gathered = x[idx]                       # (N, L) or (N, L, K)
        if x.ndim == 1:
            return diag * x + (val * gathered).sum(axis=1)
        return diag[:, None] * x + (val[..., None] * gathered).sum(axis=1)

    def spectral_gap(self, iters: int = 1000, seed: int = 0) -> float:
        """1 - |lambda_2(W)| via deflated power iteration (O(nnz) a step)."""
        from .topology import power_iteration_gap
        return power_iteration_gap(self.mix_host, self.n, iters=iters,
                                   seed=seed)

    # -- stats / views (host-side) ------------------------------------------
    @property
    def nnz(self) -> int:
        """Stored entries (off-diagonal edges + the N diagonal entries)."""
        return int(self.row_nnz.sum().item()) + self.n

    @property
    def density(self) -> float:
        return self.nnz / float(self.n * self.n)

    def row_stats(self) -> dict:
        nnz = self.row_nnz.cpu().numpy()
        return {"n": self.n, "ell_width": self.ell_width,
                "nnz": self.nnz, "density": self.density,
                "row_nnz_min": int(nnz.min()), "row_nnz_max": int(nnz.max()),
                "row_nnz_mean": float(nnz.mean())}

    def csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host CSR view (indptr, indices, data) of the off-diagonal part."""
        idx = self.ell_idx.cpu().numpy()
        val = self.ell_val.cpu().numpy()
        nnz = self.row_nnz.cpu().numpy()
        keep = np.arange(self.ell_width)[None, :] < nnz[:, None]
        indptr = np.zeros(self.n + 1, np.int64)
        np.cumsum(nnz, out=indptr[1:])
        return indptr, idx[keep].astype(np.int64), val[keep]

    def to_dense(self) -> torch.Tensor:
        """Dense (N, N) round trip (padded slots add 0 on the diagonal)."""
        rows = torch.arange(self.n, device=self.device)[:, None].expand(
            self.n, self.ell_width)
        dense = torch.zeros((self.n, self.n), dtype=self.ell_val.dtype,
                            device=self.device)
        dense.index_put_((rows, self.ell_idx.long()), self.ell_val,
                         accumulate=True)
        ar = torch.arange(self.n, device=self.device)
        dense[ar, ar] += self.diag
        return dense
