"""Self-healing gossip under network faults: the twin of
``repro/core/netfaults.py``.

``NetFaultModel`` declares the faults, which all compose:

* link drops: each undirected link fails i.i.d. with ``p_drop`` a round
  (both directions together, which keeps the realized round doubly
  stochastic);
* bursty outages: a Gilbert-Elliott chain per link (``p_bad`` into the bad
  state, ``p_good`` out of it); the state rides in the run's carry across
  rounds and outer iterations, so a chunked resume replays bursts exactly;
* crash/rejoin: a node leaves for a window of outer iterations
  (``crash_windows``); its edges are masked, the executors freeze its
  iterate, and on rejoin it re-syncs through ordinary gossip;
* payload corruption: a node's outbound messages are scaled by
  ``corrupt_scale`` (or set to NaN) with probability ``p_corrupt`` a round;
  every receiver screens (NaN or max |entry| above ``guard_norm``) and a
  rejected sender degrades to a dropped node for the round, its message
  zeroed before any product, so a NaN never reaches a matmul or the ELL
  kernel.

Every realized round returns the dropped weights to the diagonal
(``consensus.realized_round_weights``) and carries the realized product
``p = Pi W e_1``, so the exact debias of Alg. 1 holds under any fault mix.

The draws are the port's own stream (``async_gossip`` says how): one call
of ``sample_faults``, or one gossip call of a fused outer step, is one draw
of the engine's counter. A dense engine draws (T, N, N) symmetric uniforms
for drops and bursts, as the reference does; a sparse (ELL) engine draws
one uniform per undirected edge, the same law, and writes it to both of
the edge's slots, giving (T, N, L) slot-form blocks (the reference's dense
(T, N, N) draws at N = 4096 would be 1.3 GB a block). ``dense_to_slots``
gathers dense blocks at the slots exactly as the reference's sparse round
does, so the reference's draws can be injected into a sparse engine;
``slots_to_dense`` scatters slot blocks back to (T, N, N) for a dense
engine fed the same draws.

Execution modes:
  * fused: ``masked_faulty_rounds`` runs the live rounds of a pre-sampled
    block on the device, with no host sync (sparse engines: one ELL kernel
    launch a round);
  * eager per-round (``run_rounds_eager``): the same round function called
    once a round; the same bits as the fused rounds;
  * host (``fused=False``): the float32 NumPy oracle, dense engines only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..obs import get_journal
from .async_gossip import GossipDraws, draw_generator, engine_key
from .consensus import debias_table, realized_round_weights, safe_debias_scale
from .metrics import CommLedger
from .sparse import SparseW, auto_sparse
from .topology import Graph, local_degree_weights

__all__ = ["NetFaultModel", "FaultyConsensus", "masked_faulty_rounds",
           "sample_fault_blocks", "realized_debias", "dense_to_slots",
           "slots_to_dense", "edge_slots"]

_CORRUPT_MODES = ("scale", "nan")
_DEBIAS_MODES = ("realized", "nominal")


# ---------------------------------------------------------------------------
# declarative fault model
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NetFaultModel:
    """Declarative network-fault configuration (all faults compose).

    ``crash_windows`` is (node, start_iter, n_iters) triples at
    outer-iteration granularity; ``node_up(t_outer, n)`` lowers them to a
    (T, N) schedule.
    """

    p_drop: float = 0.0          # i.i.d. per-link drop prob per round
    p_bad: float = 0.0           # Gilbert-Elliott: good -> bad per round
    p_good: float = 1.0          # Gilbert-Elliott: bad -> good per round
    p_corrupt: float = 0.0       # per-node outbound corruption prob/round
    corrupt_mode: str = "scale"  # "scale" | "nan"
    corrupt_scale: float = 1e9   # payload blow-up factor in "scale" mode
    guard_norm: float = 1e6      # receiver reject threshold (max |entry|)
    crash_windows: Tuple[Tuple[int, int, int], ...] = ()

    def validate(self, n_nodes: Optional[int] = None,
                 t_outer: Optional[int] = None) -> "NetFaultModel":
        for name in ("p_drop", "p_bad", "p_good", "p_corrupt"):
            v = float(getattr(self, name))
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}: must be in [0, 1], got {v}")
        if self.p_bad > 0.0 and self.p_good <= 0.0:
            raise ValueError("p_good: must be > 0 when p_bad > 0 "
                             "(a burst must be able to end)")
        if self.corrupt_mode not in _CORRUPT_MODES:
            raise ValueError(f"corrupt_mode: expected one of "
                             f"{_CORRUPT_MODES}, got {self.corrupt_mode!r}")
        if not float(self.corrupt_scale) > 0.0:
            raise ValueError(f"corrupt_scale: must be > 0, "
                             f"got {self.corrupt_scale}")
        if not float(self.guard_norm) > 0.0:
            raise ValueError(f"guard_norm: must be > 0, "
                             f"got {self.guard_norm}")
        for k, win in enumerate(self.crash_windows):
            if len(win) != 3:
                raise ValueError(f"crash_windows[{k}]: expected "
                                 "(node, start, len)")
            node, start, length = (int(x) for x in win)
            if node < 0 or (n_nodes is not None and node >= n_nodes):
                raise ValueError(f"crash_windows[{k}].node: {node} out of "
                                 f"range for {n_nodes} nodes")
            if start < 0:
                raise ValueError(f"crash_windows[{k}].start: must be >= 0, "
                                 f"got {start}")
            if length <= 0:
                raise ValueError(f"crash_windows[{k}].len: must be > 0, "
                                 f"got {length}")
            if t_outer is not None and start >= t_outer:
                raise ValueError(f"crash_windows[{k}].start: {start} is "
                                 f"past t_outer={t_outer}")
        return self

    def params(self, device: DeviceLike = "cpu") -> torch.Tensor:
        """(6,) float32 tensor of the per-round scalar knobs:
        [p_drop, p_bad, p_good, p_corrupt, corrupt_value, guard_norm];
        corrupt_value is NaN in "nan" mode."""
        cval = (np.nan if self.corrupt_mode == "nan"
                else float(self.corrupt_scale))
        return torch.tensor([self.p_drop, self.p_bad, self.p_good,
                             self.p_corrupt, cval, self.guard_norm],
                            dtype=torch.float32, device=device)

    def node_up(self, t_outer: int, n: int) -> np.ndarray:
        """(t_outer, N) float32 schedule: 0.0 while a node is crashed."""
        up = np.ones((max(int(t_outer), 1), int(n)), np.float32)
        for node, start, length in self.crash_windows:
            up[int(start):int(start) + int(length), int(node)] = 0.0
        return up[:int(t_outer)] if t_outer else up[:0]

    @property
    def mean_burst_len(self) -> float:
        return 1.0 / float(self.p_good) if self.p_good > 0 else float("inf")


# ---------------------------------------------------------------------------
# the draws: dense symmetric blocks, or one uniform an edge in slot form
# ---------------------------------------------------------------------------
def edge_slots(sw: SparseW) -> torch.Tensor:
    """(2, E) flat slot indices (into N * L) of every undirected edge i < j
    of a ``SparseW``: row 0 the slot of j in row i, row 1 that of i in row
    j. Built from the host indices."""
    idx = sw.ell_idx.cpu().numpy()
    nnz = sw.row_nnz.cpu().numpy()
    n, width = idx.shape
    rows, slots = np.nonzero(np.arange(width)[None, :] < nnz[:, None])
    cols = idx[rows, slots]
    flat = {(int(i), int(j)): int(i) * width + int(s)
            for i, s, j in zip(rows, slots, cols)}
    upper = [(i, j) for (i, j) in flat if i < j]
    pairs = np.array([[flat[(i, j)], flat[(j, i)]] for i, j in upper],
                     np.int64).reshape(-1, 2)
    return torch.from_numpy(pairs.T.copy()).to(sw.device)


def _sym_uniform(gen: torch.Generator, rows: int, n: int) -> torch.Tensor:
    """(rows, N, N) uniforms mirrored from the upper triangle (one draw an
    undirected link a round), diagonal 0."""
    u = torch.rand((rows, n, n), generator=gen, device=gen.device)
    up = torch.triu(u, 1)
    return up + up.transpose(1, 2)


def _slot_uniform(gen: torch.Generator, rows: int, n: int, width: int,
                  slots: torch.Tensor) -> torch.Tensor:
    """(rows, N, L) uniforms, one an undirected edge written to both of its
    slots; padded slots 0 (the value a dense block holds on its
    diagonal, where they point)."""
    u_e = torch.rand((rows, slots.shape[1]), generator=gen,
                     device=gen.device)
    u = torch.zeros((rows, n * width), device=gen.device)
    u[:, slots[0]] = u_e
    u[:, slots[1]] = u_e
    return u.reshape(rows, n, width)


def sample_fault_blocks(gen: torch.Generator, n: int, rows: int,
                        slots: Optional[Tuple[torch.Tensor, int]] = None):
    """One gossip call's fault draws from ``gen``: ``(u_drop, u_burst,
    u_corrupt)``, two (rows, N, N) symmetric blocks (or, with ``slots`` =
    (``edge_slots``, L), two (rows, N, L) slot-form blocks) and one
    (rows, N) block."""
    if slots is None:
        u_drop = _sym_uniform(gen, rows, n)
        u_burst = _sym_uniform(gen, rows, n)
    else:
        pairs, width = slots
        u_drop = _slot_uniform(gen, rows, n, width, pairs)
        u_burst = _slot_uniform(gen, rows, n, width, pairs)
    u_cor = torch.rand((rows, n), generator=gen, device=gen.device)
    return u_drop, u_burst, u_cor


def dense_to_slots(ell_idx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Gather (T, N, N) dense draws at the ELL slots: (T, N, L), as the
    reference's sparse round does (``take_along_axis``)."""
    idx = ell_idx.long().to(u.device)
    return torch.gather(u, 2, idx.expand(u.shape[0], *idx.shape))


def slots_to_dense(ell_idx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Scatter (T, N, L) slot draws to (T, N, N) blocks (0 off the edges),
    so a dense engine sees the masks a sparse one does."""
    t, n, _ = u.shape
    idx = ell_idx.long().to(u.device)
    dense = torch.zeros((t, n, n), dtype=u.dtype, device=u.device)
    return dense.scatter_(2, idx.expand(t, *idx.shape), u)


# ---------------------------------------------------------------------------
# realized faulty rounds
# ---------------------------------------------------------------------------
def _screen(z: torch.Tensor, params: torch.Tensor, u_cor: torch.Tensor):
    """Corrupt the outbound messages and screen them at the receivers:
    (msg, valid (N,) bool). A NaN payload fails both tests."""
    p_cor, cval, guard = params[3], params[4], params[5]
    bshape = (-1,) + (1,) * (z.dim() - 1)
    factor = torch.where(u_cor < p_cor, cval, torch.ones_like(cval))
    msg = z * factor.to(z.dtype).reshape(bshape)
    flat = msg.reshape(z.shape[0], -1)
    valid = torch.isfinite(flat).all(dim=1) & (flat.abs().amax(dim=1) <= guard)
    return msg, valid


def _faulty_round(wz, adj_b, off, params, up_pair, node_up, z, p, ge,
                  u_drop, u_burst, u_cor):
    """One realized faulty round: mask, renormalise, mix, account. The
    fused rounds and the eager per-round loop both call it."""
    p_drop, p_bad, p_good = params[0], params[1], params[2]
    n = z.shape[0]
    bshape = (-1,) + (1,) * (z.dim() - 1)
    # Gilbert-Elliott per-edge chain: transition first, then the new state
    # gates this round (a burst that starts this round already bites)
    ge_next = torch.where(ge, u_burst >= p_good, u_burst < p_bad)
    msg, valid = _screen(z, params, u_cor)
    # the surviving symmetric edge set: real edges between up nodes, not
    # dropped, not in a burst, and neither endpoint's payload rejected
    mask = (adj_b & up_pair & ~ge_next & (u_drop >= p_drop)
            & valid[:, None] & valid[None, :])
    w_off, dd = realized_round_weights(wz, mask, off)
    # zero rejected payloads before the product: a masked weight times a
    # NaN is still NaN
    msg_clean = torch.where(valid.reshape(bshape), msg, torch.zeros_like(msg))
    # the diagonal applies each node's own (uncorrupted) state, the
    # off-diagonal weights the screened messages; p rides as one more column
    mixed = w_off @ torch.cat([msg_clean.reshape(n, -1), p[:, None]], dim=1)
    z_next = dd.reshape(bshape) * z + mixed[:, :-1].reshape(z.shape)
    p_next = dd * p + mixed[:, -1]
    sends = (off & mask).sum().to(torch.float32)
    return z_next, p_next, ge_next, sends, node_up.sum()


def _sparse_faulty_round(sw, zero_diag, slot_ok, params, up, node_up, z, p,
                         ge, u_drop, u_burst, u_cor):
    """ELL-form twin of ``_faulty_round`` over (N, L) slot-form draws: the
    masks live on the stored slots, dropped mass returns to each row's
    diagonal (exactly 1 for an isolated node), and the screened messages
    mix through one ELL kernel launch with the round's masked slot weights
    and a zero diagonal. The burst state is (N, L)."""
    p_drop, p_bad, p_good = params[0], params[1], params[2]
    bshape = (-1,) + (1,) * (z.dim() - 1)
    idx = sw.ell_idx.long()
    ge_next = torch.where(ge, u_burst >= p_good, u_burst < p_bad)
    msg, valid = _screen(z, params, u_cor)
    mask = (slot_ok & up[:, None] & up[idx] & ~ge_next & (u_drop >= p_drop)
            & valid[:, None] & valid[idx])
    wv = sw.ell_val.to(z.dtype)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    w_off = torch.where(mask, wv, zero)
    dd = sw.diag.to(z.dtype) + torch.where(slot_ok & ~mask, wv, zero).sum(1)
    dd = torch.where(mask.any(dim=1), dd, torch.ones_like(dd))
    msg_clean = torch.where(valid.reshape(bshape), msg, torch.zeros_like(msg))
    z_next = (dd.reshape(bshape) * z
              + sw.offdiag_mix(zero_diag, w_off, msg_clean))
    p_next = dd * p + (w_off * p[idx]).sum(dim=1)
    sends = mask.sum().to(torch.float32)
    return z_next, p_next, ge_next, sends, node_up.sum()


def _round_fn(w, adj, params, node_up, dtype):
    """The round function of ``w`` (dense or ``SparseW``) under one outer
    iteration's crash mask: ``step(z, p, ge, u_drop, u_burst, u_cor)``."""
    node_up = node_up.to(torch.float32)
    up = node_up > 0
    if isinstance(w, SparseW):
        slot_ok = (torch.arange(w.ell_width, device=w.device)[None, :]
                   < w.row_nnz[:, None])
        zero_diag = torch.zeros_like(w.diag, dtype=torch.float32)
        return lambda *a: _sparse_faulty_round(
            w, zero_diag, slot_ok, params, up, node_up, *a)
    n = w.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=w.device)
    wz, adj_b = w.to(dtype), adj > 0
    up_pair = up[:, None] & up[None, :]
    return lambda *a: _faulty_round(wz, adj_b, off, params, up_pair,
                                    node_up, *a)


def _e1(z: torch.Tensor) -> torch.Tensor:
    """e_1 over z's nodes, made on z's device without a host copy."""
    return (torch.arange(z.shape[0], device=z.device) == 0).to(z.dtype)


def masked_faulty_rounds(w, adj, params, node_up, ge0, blocks, t_c,
                         z_stack):
    """Faulty gossip: ``t_c`` realized edge-mask rounds of pre-sampled
    ``blocks`` (first axis T >= t_c; the rounds past t_c are not live).

    w: (N, N) nominal weights or a ``SparseW`` (then ``blocks`` are in slot
    form and ``ge0`` is (N, L)); adj: (N, N) 0/1 adjacency (unused by the
    sparse branch); params: ``NetFaultModel.params()``; node_up: (N,) 0/1
    crash mask of this outer iteration; ge0: the Gilbert-Elliott bad state
    at entry. Returns ``(z, p, ge, sends, counts)``: the undebiased mixed
    stack, the realized column ``p = Pi W e_1`` (``realized_debias``
    divides by it), the final burst state, and (T,) sends and up-node
    counts a round (0.0 past t_c).
    """
    u_drop, u_burst, u_cor = blocks
    rows, t_c = u_drop.shape[0], int(t_c)
    if t_c > rows:
        raise ValueError(f"the fault blocks have {rows} rounds but "
                         f"t_c={t_c}")
    step = _round_fn(w, adj, params, node_up, z_stack.dtype)
    z, ge, p = z_stack, ge0, _e1(z_stack)
    sends, counts = [], []
    for t in range(t_c):
        z, p, ge, s, c = step(z, p, ge, u_drop[t], u_burst[t], u_cor[t])
        sends.append(s)
        counts.append(c)
    pad = (0, rows - t_c)
    zeros = torch.zeros((0,), dtype=torch.float32, device=z_stack.device)
    return (z, p, ge,
            F.pad(torch.stack(sends) if sends else zeros, pad),
            F.pad(torch.stack(counts) if counts else zeros, pad))


def realized_debias(z: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Exact per-node debias by the realized mixing product (guarded)."""
    bshape = (-1,) + (1,) * (z.dim() - 1)
    return z / safe_debias_scale(p).to(z.dtype).reshape(bshape)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FaultyConsensus:
    """Gossip under the fault taxonomy of ``NetFaultModel``.

    Seeded link drops, bursts, crash/rejoin and payload corruption over any
    explicit graph; every realized round is renormalised and the realized
    product carried for the exact debias. The burst state and the draw
    counter persist on the engine between calls, as the fused executors
    carry both through their steps.

    ``debias``: "realized" divides by the carried ``Pi W e_1`` (the
    self-healing correction); "nominal" by the fault-free ``W^t e_1`` row
    (the uncorrected arm). ``sparse``/``payload_dtype`` as for
    ``DenseConsensus``. ``device`` defaults to CUDA.
    """

    graph: Graph
    faults: NetFaultModel = dataclasses.field(default_factory=NetFaultModel)
    seed: int = 0
    fused: bool = True           # device rounds vs the host NumPy oracle
    debias: str = "realized"     # "realized" | "nominal"
    sparse: Optional[bool] = None         # None = auto_sparse policy
    payload_dtype: Optional[str] = None   # e.g. "bfloat16" (sparse only)
    device: DeviceLike = None

    def __post_init__(self):
        if self.debias not in _DEBIAS_MODES:
            raise ValueError(f"debias: expected one of {_DEBIAS_MODES}, "
                             f"got {self.debias!r}")
        self.device = resolve_device(self.device)
        self.faults.validate(self.graph.n_nodes)
        self.weights = local_degree_weights(self.graph)
        self._sparse = auto_sparse(self.graph.n_nodes, self.graph.density,
                                   self.sparse)
        if self._sparse and not self.fused:
            raise ValueError("sparse=True requires fused=True: the NumPy "
                             "host oracle is dense-only (use a dense "
                             "engine as the oracle instead)")
        if self.payload_dtype is not None and not self._sparse:
            raise ValueError("payload_dtype (bf16 gossip) requires the "
                             "sparse mixing path (sparse=True)")
        if self._sparse:
            self._w = SparseW.from_dense(self.weights, self.graph.adjacency,
                                         payload_dtype=self.payload_dtype,
                                         device=self.device)
            self._slots = (edge_slots(self._w), self._w.ell_width)
        else:
            self._w = torch.as_tensor(np.asarray(self.weights, np.float32),
                                      device=self.device)
            self._slots = None
        self._adj = torch.as_tensor(
            np.asarray(self.graph.adjacency, np.float32), device=self.device)
        self._params = self.faults.params(self.device)
        self._debias_tables = {}
        self.reset()
        get_journal().event(
            "netfault_model", "chaos", n_nodes=self.graph.n_nodes,
            seed=int(self.seed), debias=self.debias,
            p_drop=float(self.faults.p_drop),
            p_bad=float(self.faults.p_bad),
            p_corrupt=float(self.faults.p_corrupt),
            n_crash_windows=len(self.faults.crash_windows))

    @property
    def n_nodes(self) -> int:
        return self.graph.n_nodes

    @property
    def is_sparse(self) -> bool:
        return self._sparse

    @property
    def payload_bytes_per_elem(self) -> float:
        """Wire bytes per payload element (2.0 under bf16 gossip)."""
        return 2.0 if self.payload_dtype == "bfloat16" else 4.0

    def reset(self) -> None:
        """Rewind the fault stream: counter 0, every link in the good state
        ((N, L) burst state for a sparse engine)."""
        self._key = engine_key(self.seed)
        shape = ((self.n_nodes, self._w.ell_width) if self._sparse
                 else (self.n_nodes, self.n_nodes))
        self._ge = torch.zeros(shape, dtype=torch.bool, device=self.device)

    def debias_row(self, t_c: int) -> torch.Tensor:
        """Nominal (fault-free) debias row [W^{t_c} e_1]: the uncorrected
        arm's divisor (cached per t_c)."""
        t_c = int(t_c)
        if t_c not in self._debias_tables:
            self._debias_tables[t_c] = debias_table(self._w, t_c)[t_c]
        return self._debias_tables[t_c]

    # -- the draws ---------------------------------------------------------
    def _draw(self, counter: int, rows: int):
        """The fault blocks of draw ``counter``, padded to ``rows`` rounds
        (slot form for a sparse engine)."""
        return sample_fault_blocks(
            draw_generator(self.seed, counter, self.device), self.n_nodes,
            rows, self._slots)

    def _prepare(self, blocks):
        """Injected ``(u_drop, u_burst, u_corrupt)`` as f32 tensors on the
        device; a sparse engine gathers dense (T, N, N) blocks at its
        slots."""
        def dev(b):
            t = b if isinstance(b, torch.Tensor) else torch.as_tensor(
                np.array(b))
            return t.to(device=self.device, dtype=torch.float32)

        u_drop, u_burst, u_cor = (dev(b) for b in blocks)
        if self._sparse and u_drop.shape[-1] == self.n_nodes:
            u_drop = dense_to_slots(self._w.ell_idx, u_drop)
            u_burst = dense_to_slots(self._w.ell_idx, u_burst)
        return u_drop, u_burst, u_cor

    def _node_up(self, node_up) -> torch.Tensor:
        """An (N,) crash mask (array or tensor) as f32 on the device."""
        if not isinstance(node_up, torch.Tensor):
            node_up = torch.as_tensor(np.array(node_up, np.float32))
        return node_up.to(self.device, torch.float32)

    def sample_faults(self, t_c: int, t_max: Optional[int] = None):
        """The next call's fault blocks from the engine's stream, advancing
        its counter; ``t_max`` pads the draw and returns its first t_c
        rounds, as the fused executors draw."""
        rows = int(t_c if t_max is None else t_max)
        blocks, self._key = GossipDraws.of(self).take(self._key, rows)
        return tuple(b[:int(t_c)] for b in blocks)

    # -- gossip ------------------------------------------------------------
    def run_debiased(self, z_stack: torch.Tensor, t_c: int,
                     ledger: Optional[CommLedger] = None,
                     faults=None, node_up=None) -> torch.Tensor:
        """``t_c`` realized faulty rounds and the debias (realized or
        nominal). ``faults`` injects pre-sampled blocks (the first t_c
        rounds are used); ``node_up`` the (N,) crash mask of the outer
        iteration (default: every node up). The burst state advances on the
        engine across calls."""
        t_c = int(t_c)
        if faults is None:
            faults = self.sample_faults(t_c)
        else:
            faults = tuple(b[:t_c] for b in self._prepare(faults))
        node_up = self._node_up(
            np.ones(self.n_nodes, np.float32) if node_up is None else node_up)
        z = z_stack.float()
        if self.fused:
            zz, p, ge, sends, counts = masked_faulty_rounds(
                self._w, self._adj, self._params, node_up, self._ge, faults,
                t_c, z)
        else:
            zz, p, ge, sends, counts = self._run_host(z, node_up, faults)
        self._ge = ge
        if ledger is not None:
            total = float(sends.double().sum())
            payload = float(np.prod(z_stack.shape[1:]))
            ledger.p2p += total
            ledger.matrices += total
            ledger.scalars += total * payload
            ledger.payload_bytes += (total * payload
                                     * self.payload_bytes_per_elem)
            ledger.log_awake_rounds(counts)
        if self.debias == "realized":
            return realized_debias(zz, p)
        bshape = (-1,) + (1,) * (z.dim() - 1)
        return zz / self.debias_row(t_c).to(zz.dtype).reshape(bshape)

    def run_rounds_eager(self, z_stack, node_up, faults):
        """Every round of ``faults``, the round function called once a
        round from this loop: the bits of ``masked_faulty_rounds``. Returns
        ``(z, p, ge, sends, counts)`` and leaves the engine's burst state
        alone."""
        faults, node_up = self._prepare(faults), self._node_up(node_up)
        z = z_stack.float()
        step = _round_fn(self._w, self._adj, self._params, node_up, z.dtype)
        p, ge, sends, counts = _e1(z), self._ge, [], []
        for t in range(faults[0].shape[0]):
            z, p, ge, s, c = step(z, p, ge, *(b[t] for b in faults))
            sends.append(s)
            counts.append(c)
        return z, p, ge, torch.stack(sends), torch.stack(counts)

    def _run_host(self, z_stack, node_up, faults):
        """The float32 NumPy oracle: the masks and operation order of
        ``_faulty_round``, written independently."""
        n = self.n_nodes
        dev = z_stack.device
        off = ~np.eye(n, dtype=bool)
        w = np.asarray(self.weights, np.float32)
        adj_b = np.asarray(self.graph.adjacency) > 0
        p_drop, p_bad, p_good, p_cor, cval, guard = (
            self._params.cpu().numpy())
        node_up = node_up.cpu().numpy()
        up = node_up > 0
        up_pair = np.outer(up, up)
        z = z_stack.cpu().numpy()
        bshape = (-1,) + (1,) * (z.ndim - 1)
        axes = tuple(range(1, z.ndim))
        p = np.zeros((n,), np.float32)
        p[0] = 1.0
        ge = self._ge.cpu().numpy()
        u_drop, u_burst, u_cor = (b.cpu().numpy() for b in faults)
        sends, counts = [], []
        for t in range(u_drop.shape[0]):
            ge = np.where(ge, u_burst[t] >= p_good, u_burst[t] < p_bad)
            factor = np.where(u_cor[t] < p_cor, cval,
                              np.float32(1.0)).astype(np.float32)
            msg = z * factor.reshape(bshape)
            with np.errstate(invalid="ignore"):
                finite = np.all(np.isfinite(msg), axis=axes)
                peak = np.max(np.abs(msg), axis=axes)
                valid = finite & (peak <= guard)
            mask = (adj_b & up_pair & ~ge & (u_drop[t] >= p_drop)
                    & valid[:, None] & valid[None, :])
            w_off = np.where(off & mask, w, np.float32(0.0))
            dd = (np.diag(w)
                  + np.where(off & ~mask, w, np.float32(0.0)).sum(axis=1))
            dd = np.where((off & mask).any(axis=1), dd, np.float32(1.0))
            msg_clean = np.where(valid.reshape(bshape), msg,
                                 np.float32(0.0))
            z = (dd.reshape(bshape) * z
                 + np.einsum("ij,j...->i...", w_off, msg_clean))
            p = dd * p + w_off @ p
            sends.append(float((off & mask).sum()))
            counts.append(float(node_up.sum()))
        return (torch.as_tensor(z, device=dev), torch.as_tensor(p, device=dev),
                torch.as_tensor(ge, device=dev),
                torch.tensor(sends, dtype=torch.float32),
                torch.tensor(counts, dtype=torch.float32))

    def realized_round_matrix(self, mask: np.ndarray) -> np.ndarray:
        """Host reference: the (N, N) realized doubly stochastic round
        matrix of a symmetric surviving-edge mask."""
        n = self.n_nodes
        off = ~np.eye(n, dtype=bool)
        mask = np.asarray(mask, bool)
        w = np.where(off & mask, self.weights, 0.0)
        dd = (self.weights.diagonal()
              + np.where(off & ~mask, self.weights, 0.0).sum(axis=1))
        np.fill_diagonal(w, np.where((off & mask).any(axis=1), dd, 1.0))
        return w
