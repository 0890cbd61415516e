"""Consensus-averaging engines: the twin of ``repro/core/consensus.py``.

``DenseConsensus`` holds all N node blocks on one device and computes the
gossip recursion ``Z_i <- sum_j w_ij Z_j``: a matmul with the (N, N) weight
matrix, or, for a large sparse network, an ELL round through the Hopper
kernel (``SparseW.mix``). ``SpmdConsensus`` runs the same recursion with one
process a node, over a ``torch.distributed`` process group
(``launch/mesh.py``). All expose the paper's debias step
``V_i = Z_i^{(Tc)} / [W^{Tc} e_1]_i`` (Alg. 1, step 11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .metrics import CommLedger
from .sparse import SparseW, auto_sparse
from .topology import Graph, local_degree_weights, ring

__all__ = [
    "DenseConsensus",
    "SparseConsensus",
    "SpmdConsensus",
    "two_level_reduce",
    "consensus_schedule",
    "debias_weights",
    "debias_table",
    "debiased_gossip",
    "gossip_mix",
    "lane_debiased_gossip",
    "masked_gossip",
    "realized_round_weights",
    "safe_debias_scale",
]


def realized_round_weights(wz: torch.Tensor, mask: torch.Tensor,
                           off: torch.Tensor):
    """Renormalise the nominal weights over one round's surviving edges.

    ``wz``: (N, N) nominal weights; ``mask``: (..., N, N) bool, symmetric,
    edge survived (a leading batch of rounds is one batched op); ``off``:
    (N, N) bool off-diagonal selector. Returns ``(w_off, dd)``: the
    surviving off-diagonal weights and the diagonal with every dropped
    weight returned to it. A node whose every link dropped gets a diagonal
    of exactly 1.
    """
    zero = torch.zeros((), dtype=wz.dtype, device=wz.device)
    w_off = torch.where(off & mask, wz, zero)
    dropped = torch.where(off & ~mask, wz, zero).sum(dim=-1)
    dd = torch.diagonal(wz, dim1=-2, dim2=-1) + dropped
    isolated = ~torch.any(off & mask, dim=-1)
    return w_off, torch.where(isolated, torch.ones_like(dd), dd)


def safe_debias_scale(p: torch.Tensor) -> torch.Tensor:
    """Debias divisor from a realized mixing product: 1 wherever the
    realized mass is below the 1e-6 clamp (same direction, bounded size)."""
    return torch.where(p > 1e-6, p, torch.ones_like(p))


def gossip_mix(wz, z: torch.Tensor) -> torch.Tensor:
    """One gossip application ``out_i = sum_j w_ij z_j``: the seam between
    dense mixing (``wz`` an (N, N) tensor, a plain matmul) and sparse
    mixing (``wz`` a ``SparseW``, the ELL kernel).

    A (B, N, N) ``wz`` is a stack of B sub-networks (B-DOT's grid columns
    or rows) mixing z: (B, N, ...) in one batched matmul, and a stacked
    ``SparseW`` (``SparseW.stack``) mixes it in one batched ELL launch;
    both stand in for the reference's ``jax.vmap`` over engines.
    """
    if isinstance(wz, SparseW):
        return wz.mix(z)
    if wz.dim() == 3:
        b, n = z.shape[:2]
        return torch.bmm(wz, z.reshape(b, n, -1)).reshape(z.shape)
    n = z.shape[0]
    return (wz @ z.reshape(n, -1)).reshape(z.shape)


def _gossip(w, z_stack: torch.Tensor, t_c: int) -> torch.Tensor:
    wz = w.astype(z_stack.dtype) if isinstance(w, SparseW) else w.to(z_stack.dtype)
    for _ in range(int(t_c)):
        z_stack = gossip_mix(wz, z_stack)
    return z_stack


def masked_gossip(w, z_stack: torch.Tensor, t_c: int, t_max: int
                  ) -> torch.Tensor:
    """``t_c`` gossip rounds out of a budget of ``t_max``.

    The reference runs ``t_max`` rounds and masks those past ``t_c`` so that
    one compiled program serves every budget; the masked rounds are
    identities, so here the budget is host data and exactly ``t_c`` rounds
    run.
    """
    if t_c > t_max:
        raise ValueError(f"t_c={t_c} exceeds the budget t_max={t_max}")
    return _gossip(w, z_stack, t_c)


def debias_table(w, t_max: int) -> torch.Tensor:
    """Debias weights [W^t e_1] for every t in 0..t_max: (t_max + 1, N).

    Row t equals ``debias_weights(w, t)`` (same 1e-6 clamp), built as one
    chain of W^T matvecs on the device. A ``SparseW`` is symmetric, so its
    matvec is the ordinary sparse mix (one ELL launch per row).
    """
    n = w.shape[0]
    sparse = isinstance(w, SparseW)
    dtype = torch.float32 if sparse else w.dtype
    p = torch.zeros((n,), dtype=dtype, device=w.device)
    p[0] = 1.0
    rows = [p]
    for _ in range(int(t_max)):
        p = w.mix(p) if sparse else w.T @ p
        rows.append(p)
    return torch.stack(rows).clamp_min(1e-6)


def debiased_gossip(w, table: torch.Tensor, z_stack: torch.Tensor,
                    t_c: int, t_max: int) -> torch.Tensor:
    """masked_gossip + debias by the table row ``t_c``: the fused
    executor's inner step (no host sync).

    Batched form: ``w`` (B, N, N) or a stacked ``SparseW``, ``table``
    (B, t_max + 1, N) and ``z_stack`` (B, N, ...) run all B sub-networks at
    once, one batched matmul or ELL launch per round, each debiased by its
    own table's row ``t_c``.
    """
    out = masked_gossip(w, z_stack, t_c, t_max)
    row = table[..., int(t_c), :]                          # (N,) or (B, N)
    bshape = row.shape + (1,) * (z_stack.dim() - row.dim())
    return out / row.to(out.dtype).reshape(bshape)


def lane_debiased_gossip(ws: torch.Tensor, tables: torch.Tensor,
                         z: torch.Tensor, t_cs) -> torch.Tensor:
    """``debiased_gossip`` for a sweep's lanes, each case under its own
    budget: the reference's vmapped masked scan.

    ws: (C, N, N) case weights; tables: (C, t_max + 1, N) their debias
    tables; z: (C, S, N, ...) lanes; t_cs: the (C,) host budgets of the
    step. A round is one batched matmul over every lane; a case whose
    budget is spent keeps its lanes fixed from then on, and each lane is
    divided by its own case's table row.
    """
    c, s, n = z.shape[:3]
    t_cs = [int(t) for t in t_cs]
    wz = ws.to(z.dtype)[:, None]                             # (C, 1, N, N)
    zf = z.reshape(c, s, n, -1)
    for k in range(max(t_cs, default=0)):
        mixed = wz @ zf
        if min(t_cs) > k:
            zf = mixed
        else:                                    # some cases are done
            zf = torch.cat([mixed[i:i + 1] if t_cs[i] > k else zf[i:i + 1]
                            for i in range(c)])
    rows = torch.stack([tables[i, t] for i, t in enumerate(t_cs)])
    return (zf / rows.to(zf.dtype)[:, None, :, None]).reshape(z.shape)


def debias_weights(w: np.ndarray, t_c: int) -> np.ndarray:
    """[W^{Tc} e_1]_i for every node i on the host, clamped away from 0
    (an early SA-DOT round may not have reached every node yet; the local
    QR renormalises, so only the direction matters)."""
    n = w.shape[0]
    e1 = np.zeros(n)
    e1[0] = 1.0
    out = np.linalg.matrix_power(w.T, t_c) @ e1
    return np.maximum(out, 1e-6)


def consensus_schedule(kind: str, t_outer: int, t_max: int = 50,
                       cap: Optional[int] = None) -> np.ndarray:
    """Per-outer-iteration consensus budgets T_{c,t} of the paper's tables.

    kind: 'const' -> [t_max] * t_outer (S-DOT); 'lin_half' -> ceil(0.5 t + 1);
    'lin1' -> t + 1; 'lin2' -> 2 t + 1; 'lin5' -> 5 t + 1 (SA-DOT).
    ``cap`` clips every entry.
    """
    t = np.arange(1, t_outer + 1, dtype=np.float64)
    if kind == "const":
        sched = np.full(t_outer, float(t_max))
    elif kind == "lin_half":
        sched = np.ceil(0.5 * t + 1)
    elif kind == "lin1":
        sched = t + 1
    elif kind == "lin2":
        sched = 2 * t + 1
    elif kind == "lin5":
        sched = 5 * t + 1
    else:
        raise ValueError(f"unknown schedule kind: {kind}")
    if cap is not None:
        sched = np.minimum(sched, cap)
    return sched.astype(np.int64)


@dataclasses.dataclass
class DenseConsensus:
    """Single-device gossip simulator over an explicit graph.

    ``sparse``: ``True`` stores W as a ``SparseW`` (ELL rounds, O(nnz k)),
    ``False`` forces the dense matmul, ``None`` (default) turns sparse
    mixing on only for networks both large and sparse (``auto_sparse``).
    ``device`` defaults to CUDA and raises where no card is present.
    """

    graph: Graph
    weights: Optional[np.ndarray] = None
    sparse: Optional[bool] = None
    payload_dtype: Optional[str] = None   # e.g. "bfloat16" (sparse only)
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.weights is None:
            self.weights = local_degree_weights(self.graph)
        self._sparse = auto_sparse(self.graph.n_nodes, self.graph.density,
                                   self.sparse)
        if self._sparse:
            self._w = SparseW.from_dense(self.weights, self.graph.adjacency,
                                         payload_dtype=self.payload_dtype,
                                         device=self.device)
        elif self.payload_dtype is not None:
            raise ValueError("payload_dtype (bf16 gossip) requires the "
                             "sparse mixing path")
        else:
            self._w = torch.as_tensor(np.asarray(self.weights, np.float32),
                                      device=self.device)
        self._debias_tables: Dict[int, torch.Tensor] = {}

    @property
    def is_sparse(self) -> bool:
        return self._sparse

    @property
    def payload_bytes_per_elem(self) -> float:
        """Wire bytes per payload element: 2 for bf16 payloads, else 4."""
        return 2.0 if self.payload_dtype == "bfloat16" else 4.0

    def run(self, z_stack: torch.Tensor, t_c: int) -> torch.Tensor:
        """t_c gossip rounds on stacked blocks z_stack: (N, ...)."""
        return _gossip(self._w, z_stack, int(t_c))

    def run_debiased(self, z_stack: torch.Tensor, t_c: int,
                     ledger: Optional[CommLedger] = None) -> torch.Tensor:
        """Gossip + per-node debias: approximates sum_j Z_j at every node.

        The dense engine debiases by the host matrix power (the reference's
        eager oracle); the sparse engine by a device-table row.
        """
        t_c = int(t_c)
        out = self.run(z_stack, t_c)
        if self._sparse:
            scale = self.debias_table(t_c)[t_c]
        else:
            scale = torch.as_tensor(debias_weights(self.weights, t_c),
                                    device=out.device)
        if ledger is not None:
            payload = int(np.prod(z_stack.shape[1:]))
            ledger.log_gossip_rounds([t_c], self.graph.adjacency, payload,
                                     self.payload_bytes_per_elem)
        bshape = (-1,) + (1,) * (z_stack.dim() - 1)
        return out / scale.to(out.dtype).reshape(bshape)

    def debias_table(self, t_max: int) -> torch.Tensor:
        """Cached (t_max + 1, N) table of [W^t e_1] rows."""
        t_max = int(t_max)
        if t_max not in self._debias_tables:
            self._debias_tables[t_max] = debias_table(self._w, t_max)
        return self._debias_tables[t_max]

    def run_debiased_scan(self, z_stack: torch.Tensor, t_c: int, *,
                          t_max: int,
                          table: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Twin of run_debiased with no host sync: debiases by row ``t_c``
        of the device table (t_c <= t_max). Accounting is left to the
        caller, which prices the whole schedule in closed form."""
        if t_c > t_max:
            raise ValueError(f"t_c={t_c} exceeds the budget t_max={t_max}")
        if table is None:
            table = self.debias_table(t_max)
        return debiased_gossip(self._w, table, z_stack, t_c, t_max)


@dataclasses.dataclass
class SparseConsensus(DenseConsensus):
    """Forced-sparse gossip engine: ELL mixing regardless of size.

    ``payload_dtype="bfloat16"`` additionally quantises the neighbour
    messages to bf16 with f32 accumulation; the ledger then prices 2 bytes
    per element.
    """

    def __post_init__(self):
        if self.sparse is False:
            raise ValueError("SparseConsensus is the forced-sparse engine;"
                             " use DenseConsensus for dense mixing")
        self.sparse = True
        super().__post_init__()


class SpmdConsensus:
    """Gossip across processes: node i is rank i of ``mesh``'s axis
    ``axis`` and holds only its own block.

    A round exchanges this node's block with its neighbours in the graph,
    in one ``batch_isend_irecv`` (``AxisGroup.exchange``): the sends the
    ledger prices, no more. On a ring of n > 2 nodes W is circulant and a
    round is ``w_self * z + w_prev * z_from(i - 1) + w_next * z_from(i + 1)``;
    on any other graph (the 2-node ring included) it is ``w_ii * z`` plus
    ``w_ij * z_from(j)`` over the neighbours j in ascending order, the row
    of W that ``DenseConsensus`` applies as a matmul. The reference
    all-gathers every block there instead; with 20 gloo ranks sharing one
    card that took 63 ms a round against the exchange's 11
    (tools/gossip_transport_times.py, PERF.md).

    Under gloo a round on the card stages only its exchange: the block
    goes down to a pinned host buffer, the neighbours' blocks come back,
    and the weighted sum runs on the card. The bytes are counted in
    ``host_staged_bytes`` (``launch/mesh.AxisGroup``).
    """

    def __init__(self, mesh, axis: str, graph: Optional[Graph] = None,
                 weights: Optional[np.ndarray] = None):
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.axis(axis)
        self.n = self.group.size
        self.device = mesh.device
        self.graph = graph if graph is not None else ring(self.n)
        self.weights = (weights if weights is not None
                        else local_degree_weights(self.graph))
        if self.weights.shape != (self.n, self.n):
            raise ValueError("weight matrix does not match mesh axis size")
        i = self.index
        if np.array_equal(self.graph.adjacency, ring(self.n).adjacency) \
                and self.n > 2:
            self._peers = [(i - 1) % self.n, (i + 1) % self.n]
        else:
            self._peers = [int(j) for j in
                           np.flatnonzero(self.graph.adjacency[i]) if j != i]
        self._w_self = float(self.weights[i, i])
        self._w_peers = [float(self.weights[i, j]) for j in self._peers]
        self._w = torch.as_tensor(np.asarray(self.weights, np.float32),
                                  device=self.device)
        self._debias_tables: Dict[int, torch.Tensor] = {}

    @property
    def index(self) -> int:
        """This rank's node."""
        return self.group.index

    @property
    def host_staged_bytes(self) -> int:
        return self.group.host_staged_bytes

    def _round(self, z: torch.Tensor) -> torch.Tensor:
        recv = self.group.exchange(z, self._peers)
        out = self._w_self * z
        for w, zj in zip(self._w_peers, recv):
            out = out + w * zj
        return out

    def gossip_rounds(self, z: torch.Tensor, t_c: int) -> torch.Tensor:
        """t_c gossip rounds on this node's block."""
        for _ in range(int(t_c)):
            z = self._round(z)
        return z

    def gossip_rounds_masked(self, z: torch.Tensor, t_c: int,
                             t_max: int) -> torch.Tensor:
        """``t_c`` rounds out of a budget of ``t_max``. The reference masks
        the rounds past t_c so that XLA compiles one program; here the
        budget is host data and exactly t_c rounds run (same result)."""
        if t_c > t_max:
            raise ValueError(f"t_c={t_c} exceeds the budget t_max={t_max}")
        return self.gossip_rounds(z, t_c)

    def debias_table(self, t_max: int) -> torch.Tensor:
        """Cached (t_max + 1, N) device table of [W^t e_1] rows."""
        t_max = int(t_max)
        if t_max not in self._debias_tables:
            self._debias_tables[t_max] = debias_table(self._w, t_max)
        return self._debias_tables[t_max]

    def debias_by_table(self, z: torch.Tensor, table: torch.Tensor,
                        t_c: int) -> torch.Tensor:
        """Divide this node's block by table[t_c][node]."""
        return z / table[int(t_c), self.index].to(z.dtype)

    def debias(self, z: torch.Tensor, t_c: int) -> torch.Tensor:
        """Divide this node's block by [W^{t_c} e_1]_node (host power)."""
        scale = torch.as_tensor(debias_weights(self.weights, int(t_c)),
                                device=z.device)
        return z / scale.to(z.dtype)[self.index]

    def build_debiased_sum(self, t_c: int):
        """f(this node's block) -> this node's estimate of sum_j Z_j: the
        twin of ``DenseConsensus.run_debiased`` for the same W."""
        def debiased_sum(z: torch.Tensor) -> torch.Tensor:
            return self.debias(self.gossip_rounds(z, t_c), t_c)
        return debiased_sum


def two_level_reduce(z: torch.Tensor, *, intra_axis: str,
                     inter: SpmdConsensus, t_c: int) -> torch.Tensor:
    """Exact sum over the fast intra-pod axis of ``inter.mesh``, then t_c
    gossip rounds and the debias over the slow cross-pod axis (the
    reference's psum + ``inter`` rounds)."""
    z = inter.mesh.axis(intra_axis).all_reduce_(z.clone())
    z = inter.gossip_rounds(z, t_c)
    return inter.debias(z, t_c)
