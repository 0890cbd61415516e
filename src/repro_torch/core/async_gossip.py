"""Asynchronous, straggler-tolerant consensus: the twin of
``repro/core/async_gossip.py`` (the paper's Section V future work).

* ``AsyncConsensus``: every round each node is awake independently with
  probability ``p_awake``; sleeping nodes neither send nor mix, and every
  weight they skip returns to the diagonal, so each round's matrix stays
  doubly stochastic and the realized product ``p = Pi W e_1`` gives the
  exact debias of Alg. 1.
* ``straggler_wall_clock``: the wall-clock model of one persistent
  straggler (Table V): synchronous rounds block on it, asynchronous rounds
  do not.

The draws. The reference draws from ``jax.random`` keys, which torch cannot
replay, so the port keeps its own stream: every draw is a pure function of
(engine seed, the engine's draw counter, padded shape). ``draw_generator``
seeds a ``torch.Generator`` on the engine's device from the pair, and each
``sample_awake`` call (or fused outer step) advances the counter by one. A
run's key is the (2,) int64 host tensor ``[seed, counter]``: a chunked run
killed at any boundary redraws the same masks with no generator state
saved, and fused and eager runs that draw with the same padded ``t_max``
see the same masks. ``GossipDraws`` is where a run takes its draws from:
the engine's stream, or blocks injected by the caller (the reference's own
masks, in the parity tests). A CPU generator and a CUDA generator give
different streams from the same seed.

Execution modes (``fused`` flag):
  * fused (default): ``masked_async_rounds`` builds the round matrices of
    every live round in one batched op from the masks, then runs one matmul
    a round over the payload with the realized column ``p`` beside it; no
    host sync.
  * host (``fused=False``): the reference's float64 NumPy loop, drawing
    from a NumPy generator; the correctness oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from .consensus import realized_round_weights, safe_debias_scale
from .metrics import CommLedger
from .topology import Graph, local_degree_weights

__all__ = ["AsyncConsensus", "GossipDraws", "async_round_weights",
           "check_draws", "draw_generator", "engine_key", "engine_kind",
           "key_counter",
           "masked_async_rounds", "straggler_wall_clock"]

_SEED_MASK = (1 << 64) - 1


def engine_key(seed: int, counter: int = 0) -> torch.Tensor:
    """A run's RNG key: the (2,) int64 host tensor ``[seed, counter]``."""
    return torch.tensor([int(seed), int(counter)], dtype=torch.int64)


def key_counter(key: torch.Tensor) -> int:
    return int(key[1])


def _next_key(key: torch.Tensor) -> torch.Tensor:
    return engine_key(int(key[0]), int(key[1]) + 1)


def draw_generator(seed: int, counter: int,
                   device: torch.device) -> torch.Generator:
    """The generator of draw number ``counter`` of the stream ``seed``: a
    pure function of the pair (mixed through NumPy's SeedSequence, so
    neighbouring counters give unrelated streams)."""
    state = np.random.SeedSequence(
        [int(seed) & _SEED_MASK, int(counter)]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


def engine_kind(engine) -> str:
    """How a run gossips over ``engine``: "faulty" (``sample_faults``),
    "async" (``sample_awake``) or "sync"."""
    if hasattr(engine, "sample_faults"):
        return "faulty"
    if hasattr(engine, "sample_awake"):
        return "async"
    return "sync"


def check_draws(draws, kind: str) -> None:
    if draws is not None and kind == "sync":
        raise ValueError("draws= injects the draws of an asynchronous or "
                         "faulty engine; this engine is synchronous")


@dataclasses.dataclass
class GossipDraws:
    """Where a run takes its per-call draws from.

    ``blocks`` None: the engine's own stream (``engine._draw(counter,
    rows)``). Otherwise one injected block per gossip call, in the order
    the run makes the calls (S-DOT: one an outer step; F-DOT: three, the
    partial products then each CholeskyQR pass); ``first`` is the engine's
    counter when the run began, so block k serves counter ``first + k``.
    """

    engine: Any
    blocks: Optional[Sequence] = None
    first: int = 0

    @classmethod
    def of(cls, engine, blocks: Optional[Sequence] = None) -> "GossipDraws":
        return cls(engine, blocks, key_counter(engine._key))

    def take(self, key: torch.Tensor, rows: int):
        """(the draw of ``key``'s counter, padded to ``rows`` rounds; the
        next key)."""
        counter = key_counter(key)
        if self.blocks is None:
            out = self.engine._draw(counter, int(rows))
        else:
            k = counter - self.first
            if not 0 <= k < len(self.blocks):
                raise ValueError(
                    f"the run needs injected draw {k}, but {len(self.blocks)} "
                    "were given (one per gossip call)")
            out = self.engine._prepare(self.blocks[k])
        return out, _next_key(key)


def async_round_weights(w: torch.Tensor, awake: torch.Tensor) -> torch.Tensor:
    """(T, N, N) realized round matrices for (T, N) awake masks, in one
    batched op: the edges between awake nodes keep their weight, every
    other weight returns to the diagonal, and a node with no awake
    neighbour gets a diagonal of exactly 1."""
    n = w.shape[-1]
    off = ~torch.eye(n, dtype=torch.bool, device=w.device)
    both = awake[:, :, None] & awake[:, None, :]
    w_off, dd = realized_round_weights(w, both, off)
    return w_off + torch.diag_embed(dd)


def masked_async_rounds(w: torch.Tensor, adj: torch.Tensor,
                        awake: torch.Tensor, t_c: int,
                        z_stack: torch.Tensor):
    """Async gossip: ``t_c`` realized rounds and the realized debias.

    w: (N, N) nominal weights; adj: (N, N) 0/1 adjacency; awake: (T, N)
    bool masks (T >= t_c; rows past t_c are not live); z_stack: (N, ...).
    Returns (debiased z, (T,) directed sends a round, (T,) awake nodes a
    round), 0.0 in both for the rounds past t_c.

    Only column 0 of the realized product is read (the debias weight), so
    the (N,) vector p = Pi W e_1 rides beside the payload as one more
    column of the round's matmul. An all-asleep round is the exact identity
    with zero sends, and ``safe_debias_scale`` divides by 1 wherever p
    carries no mass, so an all-degenerate call returns its input bit for
    bit.
    """
    n, t_c = w.shape[0], int(t_c)
    rows = awake.shape[0]
    if t_c > rows:
        raise ValueError(f"awake has {rows} rounds but t_c={t_c}")
    a = awake[:t_c].to(device=z_stack.device, dtype=torch.bool)
    w_rounds = async_round_weights(w.to(z_stack.dtype), a)   # (t_c, N, N)
    zf = z_stack.reshape(n, -1)
    e1 = (torch.arange(n, device=zf.device) == 0).to(zf.dtype)
    zp = torch.cat([zf, e1[:, None]], dim=1)
    for t in range(t_c):
        zp = w_rounds[t] @ zp
    z, p = zp[:, :-1], zp[:, -1]
    off = ~torch.eye(n, dtype=torch.bool, device=zf.device)
    live = off & (adj > 0)
    sends = (live & a[:, :, None] & a[:, None, :]).sum(dim=(1, 2))
    counts = a.sum(dim=1)
    pad = (0, rows - t_c)
    sends = F.pad(sends.to(torch.float32), pad)
    counts = F.pad(counts.to(torch.float32), pad)
    scale = safe_debias_scale(p)                  # realized [Pi W e_1]_i
    out = (z / scale[:, None]).reshape(z_stack.shape)
    return out, sends, counts


@dataclasses.dataclass
class AsyncConsensus:
    """Gossip with per-round random node availability (the module
    docstring says how rounds are realized and drawn). ``device`` defaults
    to CUDA and raises where no card is present."""

    graph: Graph
    p_awake: np.ndarray          # (N,) probability each node is awake
    seed: int = 0
    fused: bool = True           # device rounds vs the host NumPy loop
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        n = self.graph.n_nodes
        self.weights = local_degree_weights(self.graph)
        self._rng = np.random.default_rng(self.seed)
        if np.isscalar(self.p_awake) or np.ndim(self.p_awake) == 0:
            self.p_awake = np.full(n, float(self.p_awake))
        self._p_awake = torch.as_tensor(np.asarray(self.p_awake, np.float32),
                                        device=self.device)
        self._w = torch.as_tensor(np.asarray(self.weights, np.float32),
                                  device=self.device)
        self._adj = torch.as_tensor(
            np.asarray(self.graph.adjacency, np.float32), device=self.device)
        self._key = engine_key(self.seed)

    @property
    def n_nodes(self) -> int:
        return self.graph.n_nodes

    @property
    def is_sparse(self) -> bool:
        return False

    @property
    def payload_bytes_per_elem(self) -> float:
        return 4.0

    # -- the draws ---------------------------------------------------------
    def _draw(self, counter: int, rows: int) -> torch.Tensor:
        """(rows, N) awake masks of draw ``counter``."""
        gen = draw_generator(self.seed, counter, self.device)
        u = torch.rand((rows, self.n_nodes), generator=gen,
                       device=self.device)
        return u < self._p_awake

    def _prepare(self, block) -> torch.Tensor:
        """An injected (T, N) mask block, as a bool tensor on the device."""
        if isinstance(block, torch.Tensor):
            return block.to(device=self.device, dtype=torch.bool)
        return torch.as_tensor(np.array(block), dtype=torch.bool,
                               device=self.device)

    def sample_awake(self, t_c: int, t_max: Optional[int] = None
                     ) -> torch.Tensor:
        """The next (t_c, N) awake masks of the engine's stream; ``t_max``
        pads the draw to (t_max, N) and returns its first t_c rows, as the
        fused executors draw."""
        rows = int(t_c if t_max is None else t_max)
        masks, self._key = GossipDraws.of(self).take(self._key, rows)
        return masks[:int(t_c)]

    # -- host reference ----------------------------------------------------
    def _round_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        """One realized round from the NumPy generator: ``(w, awake)``."""
        awake = self._rng.random(self.graph.n_nodes) < self.p_awake
        return self._apply_mask(awake), awake

    def _apply_mask(self, awake: np.ndarray) -> np.ndarray:
        """Realized (N, N) float64 mixing matrix for an awake mask."""
        w = self.weights.copy()
        n = self.graph.n_nodes
        mask = np.outer(awake, awake)
        off = ~np.eye(n, dtype=bool)
        dropped = np.where(off & ~mask, w, 0.0)
        w = np.where(off & mask, w, 0.0)
        dd = self.weights.diagonal() + dropped.sum(axis=1)
        isolated = ~(off & mask).any(axis=1)
        np.fill_diagonal(w, np.where(isolated, 1.0, dd))
        return w

    # -- gossip ------------------------------------------------------------
    def run_debiased(self, z_stack: torch.Tensor, t_c: int,
                     ledger: Optional[CommLedger] = None,
                     awake=None) -> torch.Tensor:
        """t_c async rounds and the exact realized debias: approximates
        sum_j Z_j. ``awake`` injects (>= t_c, N) masks (the first t_c rows
        are used); by default the fused path draws from the engine's
        stream and the host path from its NumPy generator."""
        t_c = int(t_c)
        if awake is not None and awake.shape[0] < t_c:
            raise ValueError(f"awake has {awake.shape[0]} rounds but "
                             f"t_c={t_c}")
        if self.fused:
            return self._run_fused(z_stack, t_c, ledger, awake)
        return self._run_host(z_stack, t_c, ledger, awake)

    def _run_fused(self, z_stack, t_c, ledger, awake):
        awake = (self.sample_awake(t_c) if awake is None
                 else self._prepare(awake)[:t_c])
        out, sends, counts = masked_async_rounds(
            self._w, self._adj, awake, t_c, z_stack.float())
        if ledger is not None:
            total = float(sends.double().sum())
            payload = float(np.prod(z_stack.shape[1:]))
            ledger.p2p += total
            ledger.matrices += total
            ledger.scalars += total * payload
            ledger.log_awake_rounds(counts)
        return out

    def _run_host(self, z_stack, t_c, ledger, awake):
        n = self.graph.n_nodes
        off = ~np.eye(n, dtype=bool)
        z = z_stack.detach().cpu().numpy().astype(np.float64)
        awake_np = None if awake is None else np.asarray(
            awake.cpu() if isinstance(awake, torch.Tensor) else awake, bool)
        prod = np.eye(n)
        for t in range(t_c):
            if awake_np is None:
                w, a = self._round_matrix()
            else:
                a = awake_np[t]
                w = self._apply_mask(a)
            z = np.einsum("ij,j...->i...", w, z)
            prod = w @ prod
            if ledger is not None:
                sends = float(((w > 0) & off).sum())
                ledger.p2p += sends
                ledger.matrices += sends
                ledger.scalars += sends * np.prod(z_stack.shape[1:])
                ledger.log_awake_rounds([int(a.sum())])
        p = prod[:, 0]                              # realized [Pi W e_1]_i
        scale = np.where(p > 1e-6, p, 1.0)          # the fused path's guard
        bshape = (-1,) + (1,) * (z_stack.dim() - 1)
        return torch.as_tensor((z / scale.reshape(bshape)).astype(np.float32),
                               device=z_stack.device)


def straggler_wall_clock(*, n_nodes: int, t_round: float, delay: float,
                         rounds_sync: int, rounds_async: int) -> dict:
    """Wall-clock model, one persistent straggler (paper Table V setting).

    Synchronous: every round blocks on the straggler -> (t_round + delay).
    Asynchronous: rounds never block (the straggler is simply asleep while
    busy); it is awake a fraction t_round/(t_round+delay) of rounds.
    """
    sync = rounds_sync * (t_round + delay)
    async_ = rounds_async * t_round
    return {
        "sync_s": sync,
        "async_s": async_,
        "speedup": sync / async_ if async_ else float("inf"),
        "straggler_duty_cycle": t_round / (t_round + delay),
    }
