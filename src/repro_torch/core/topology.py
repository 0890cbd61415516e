"""Network topologies and doubly-stochastic weight matrices (NumPy only).

The port's own copy of ``repro/core/topology.py``: the same generators
(Erdos-Renyi, ring, star, 2-D torus, complete, Watts-Strogatz,
Barabasi-Albert, random-geometric) consuming ``np.random.default_rng`` in
the same order, so adjacency and weights come out identical to the JAX
package's, and the same local-degree (Xiao & Boyd '04) and
Metropolis-Hastings weight rules.

Spectral quantities (``spectral_gap``, ``mixing_time``) route by size:
exact dense eigendecompositions for the table-scale networks, deflated
power iteration / contraction bounds beyond that and for a ``SparseW``
(through its O(nnz) host matvec ``mix_host``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "Graph",
    "validate_adjacency",
    "erdos_renyi",
    "ring",
    "star",
    "torus2d",
    "complete",
    "watts_strogatz",
    "barabasi_albert",
    "random_geometric",
    "local_degree_weights",
    "metropolis_weights",
    "mixing_time",
    "spectral_gap",
    "power_iteration_gap",
]


def validate_adjacency(adj: np.ndarray) -> np.ndarray:
    """Check a (N, N) adjacency: square, symmetric, zero diagonal, 0/1.

    Every generator (including the sparse families below) funnels through
    ``Graph``, whose ``__post_init__`` calls this — a malformed topology
    fails at construction, not as a silently non-stochastic weight matrix
    three layers later.
    """
    adj = np.asarray(adj)
    if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"adjacency must be square, got shape {adj.shape}")
    if not np.array_equal(adj, adj.T):
        raise ValueError("adjacency must be symmetric")
    if np.any(np.diagonal(adj) != 0):
        raise ValueError("adjacency must have a zero diagonal (no self "
                         "loops)")
    if not np.isin(adj, (0, 1)).all():
        raise ValueError("adjacency entries must be 0 or 1")
    return adj


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph over N nodes with an adjacency matrix (no self loops)."""

    adjacency: np.ndarray  # (N, N) 0/1 symmetric, zero diagonal

    def __post_init__(self):
        validate_adjacency(self.adjacency)

    @property
    def n_nodes(self) -> int:
        return self.adjacency.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        return self.adjacency.sum(axis=1)

    @property
    def n_edges(self) -> int:
        return int(self.adjacency.sum()) // 2

    @property
    def density(self) -> float:
        """Directed-edge fill fraction of the (N, N) matrix (diagonal
        excluded from the numerator) — the quantity the sparse-mixing
        auto-threshold keys on."""
        n = self.n_nodes
        return float(self.adjacency.sum()) / float(n * n) if n else 0.0

    def neighbors(self, i: int) -> np.ndarray:
        return np.nonzero(self.adjacency[i])[0]

    def is_connected(self) -> bool:
        n = self.n_nodes
        seen = np.zeros(n, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            u = stack.pop()
            for v in self.neighbors(u):
                if not seen[v]:
                    seen[v] = True
                    stack.append(int(v))
        return bool(seen.all())


def erdos_renyi(n: int, p: float, seed: int = 0, ensure_connected: bool = True) -> Graph:
    """Erdos-Renyi G(n, p); resamples until connected (as in the paper)."""
    rng = np.random.default_rng(seed)
    for _ in range(10_000):
        upper = rng.random((n, n)) < p
        adj = np.triu(upper, k=1)
        adj = (adj | adj.T).astype(np.float64)
        g = Graph(adj)
        if not ensure_connected or g.is_connected():
            return g
    raise RuntimeError(f"could not sample a connected ER graph (n={n}, p={p})")


def ring(n: int) -> Graph:
    adj = np.zeros((n, n))
    if n >= 3:
        idx = np.arange(n)
        adj[idx, (idx + 1) % n] = 1.0
        adj[(idx + 1) % n, idx] = 1.0
    elif n == 2:
        # a 2-ring degenerates to the single edge (the wrap-around edge IS
        # the forward edge; writing both would double-count it)
        adj[0, 1] = adj[1, 0] = 1.0
    # n <= 1: the empty graph (a 1-ring's wrap-around edge would be a self
    # loop, which Graph forbids)
    return Graph(adj)


def star(n: int) -> Graph:
    adj = np.zeros((n, n))
    adj[0, 1:] = 1.0
    adj[1:, 0] = 1.0
    return Graph(adj)


def torus2d(rows: int, cols: int) -> Graph:
    """2-D torus — the topology of a TPU ICI/DCI slice."""
    n = rows * cols
    adj = np.zeros((n, n))

    def nid(r: int, c: int) -> int:
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            u = nid(r, c)
            for v in (nid(r + 1, c), nid(r, c + 1)):
                if u != v:
                    adj[u, v] = adj[v, u] = 1.0
    return Graph(adj)


def complete(n: int) -> Graph:
    adj = np.ones((n, n)) - np.eye(n)
    return Graph(adj)


def watts_strogatz(n: int, k: int = 4, p: float = 0.1, seed: int = 0,
                   ensure_connected: bool = True) -> Graph:
    """Watts-Strogatz small-world graph: a k-nearest-neighbor ring lattice
    with each edge rewired to a uniform random endpoint with probability
    ``p``. O(N) edges (nk/2), diameter O(log N) for p > 0 — the canonical
    'sparse but fast-mixing' overlay for gossip at large N.
    """
    if k % 2 or k < 2:
        raise ValueError(f"k must be even and >= 2, got {k}")
    if k >= n:
        raise ValueError(f"need k < n, got k={k}, n={n}")
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        adj = np.zeros((n, n))
        for off in range(1, k // 2 + 1):
            idx = np.arange(n)
            adj[idx, (idx + off) % n] = 1.0
            adj[(idx + off) % n, idx] = 1.0
        # rewire each lattice edge (u, u+off) with probability p
        for off in range(1, k // 2 + 1):
            for u in range(n):
                if rng.random() >= p:
                    continue
                v_old = (u + off) % n
                candidates = np.nonzero(adj[u] == 0)[0]
                candidates = candidates[candidates != u]
                if candidates.size == 0:
                    continue
                v_new = int(rng.choice(candidates))
                adj[u, v_old] = adj[v_old, u] = 0.0
                adj[u, v_new] = adj[v_new, u] = 1.0
        g = Graph(adj)
        if not ensure_connected or g.is_connected():
            return g
    raise RuntimeError(f"could not sample a connected WS graph "
                       f"(n={n}, k={k}, p={p})")


def barabasi_albert(n: int, m: int = 2, seed: int = 0) -> Graph:
    """Barabasi-Albert scale-free graph: each arriving node attaches ``m``
    edges preferentially to high-degree nodes (degree distribution
    ~ k^-3). Connected by construction; N*m edges with a few hub rows —
    the worst case for the padded-ELL width and the reason ``SparseW``
    tracks per-row nnz stats.
    """
    if not 1 <= m < n:
        raise ValueError(f"need 1 <= m < n, got m={m}, n={n}")
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n))
    # seed clique over the first m+1 nodes keeps early attachment proper
    for u in range(m + 1):
        for v in range(u + 1, m + 1):
            adj[u, v] = adj[v, u] = 1.0
    # repeated-endpoint list: sampling uniformly from it IS preferential
    # attachment (each node appears once per incident edge)
    targets = [u for u in range(m + 1) for _ in range(m)]
    for u in range(m + 1, n):
        picked: set = set()
        while len(picked) < m:
            picked.add(int(targets[rng.integers(len(targets))]))
        for v in picked:
            adj[u, v] = adj[v, u] = 1.0
            targets.append(v)
        targets.extend([u] * m)
    return Graph(adj)


def random_geometric(n: int, radius: Optional[float] = None, seed: int = 0,
                     ensure_connected: bool = True) -> Graph:
    """Random geometric graph: n uniform points in the unit square,
    connected iff within ``radius``. Default radius is 1.5x the
    connectivity threshold sqrt(log n / (pi n)) — sparse (expected degree
    O(log n)) but connected with high probability; resamples otherwise.
    Models physical-proximity overlays (sensor meshes, rack locality).
    """
    if radius is None:
        radius = 1.5 * np.sqrt(np.log(max(n, 2)) / (np.pi * n))
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        pos = rng.random((n, 2)).astype(np.float32)
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        adj = (d2 <= radius * radius).astype(np.float64)
        np.fill_diagonal(adj, 0.0)
        g = Graph(adj)
        if not ensure_connected or g.is_connected():
            return g
    raise RuntimeError(f"could not sample a connected RGG "
                       f"(n={n}, radius={radius:.4f})")


def local_degree_weights(g: Graph) -> np.ndarray:
    """Doubly-stochastic W via local-degree (max-degree of edge endpoints).

    w_ij = 1 / (1 + max(deg_i, deg_j)) for (i,j) in E, w_ii = 1 - sum_j w_ij.
    This is the construction from Xiao & Boyd used by the paper.
    """
    a = g.adjacency
    deg = g.degrees
    n = g.n_nodes
    w = np.zeros((n, n))
    pair_max = np.maximum(deg[:, None], deg[None, :])
    mask = a > 0
    w[mask] = 1.0 / (1.0 + pair_max[mask])
    np.fill_diagonal(w, 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def metropolis_weights(g: Graph) -> np.ndarray:
    """Metropolis-Hastings weights: w_ij = 1 / max(deg_i, deg_j).

    The MH acceptance rule applied to the simple random walk (propose
    uniformly over neighbors at rate 1/deg_i, accept with min(1,
    deg_i/deg_j)) gives edge weight min(1/deg_i, 1/deg_j) =
    1/max(deg_i, deg_j); w_ii absorbs the remainder (always >= 0 since a
    row has deg_i entries each <= 1/deg_i). Doubly stochastic and
    symmetric like the local-degree rule, but WITHOUT the +1 laziness
    term — edges get strictly larger weights, and low-degree nodes shed
    all self-weight (a star's hub has w_ii = 0 here vs 1/N under
    local-degree, the distinguishing case pinned in tests). The flip side
    of no laziness: the chain can be periodic on bipartite graphs where
    some row's self-weight vanishes (ring(2) alternates forever), so
    ``mixing_time`` may be None where the local-degree chain mixes.
    """
    a = g.adjacency
    deg = g.degrees
    n = g.n_nodes
    w = np.zeros((n, n))
    mask = a > 0
    pair_max = np.maximum(deg[:, None], deg[None, :])
    w[mask] = 1.0 / pair_max[mask]
    np.fill_diagonal(w, 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def power_iteration_gap(matvec, n: int, iters: int = 1000,
                        seed: int = 0) -> float:
    """1 - |lambda_2| of a doubly-stochastic W given only ``matvec``.

    Deflated power iteration on B = W - (1/n) 1 1^T: the known top
    eigenpair (1, 1/sqrt(n)) is projected out of the iterate every step,
    so the growth rate is |lambda_2| — the gossip contraction factor —
    at O(cost(matvec)) per iteration instead of the O(N^3) dense
    eigendecomposition.
    """
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    x -= x.mean()
    nrm = np.linalg.norm(x)
    if nrm == 0.0:
        return 1.0
    x /= nrm
    lam = 0.0
    for _ in range(iters):
        y = np.asarray(matvec(x), np.float64)
        y -= y.mean()                       # re-deflate (float drift)
        nrm = np.linalg.norm(y)
        if nrm < 1e-30:                     # W is exact averaging
            return 1.0
        lam = nrm                           # ||B x|| with ||x|| = 1
        x = y / nrm
    return float(1.0 - min(lam, 1.0))


# Above this size the exact dense routes (O(N^3) eigvals / O(N^3)-ish
# repeated W^t products) give way to power iteration and the contraction
# bound.
_EXACT_SPECTRUM_MAX_N = 512


def spectral_gap(w, method: str = "auto", iters: int = 1000,
                 seed: int = 0) -> float:
    """1 - |lambda_2(W)|; gossip contraction factor per round.

    Accepts a dense (N, N) array or a ``core.sparse.SparseW`` (anything
    with a ``mix_host`` matvec). ``method``: 'exact' forces the dense
    eigendecomposition, 'power' forces deflated power iteration, 'auto'
    (default) uses exact for small dense inputs and power iteration for
    sparse or large ones.
    """
    if hasattr(w, "mix_host"):              # SparseW (duck-typed: topology
        if method == "exact":               # must not import core.sparse)
            raise ValueError("exact spectral_gap needs a dense matrix; "
                             "use SparseW.to_dense() explicitly")
        return power_iteration_gap(w.mix_host, w.n, iters=iters, seed=seed)
    w = np.asarray(w)
    n = w.shape[0]
    if method == "exact" or (method == "auto" and n <= _EXACT_SPECTRUM_MAX_N):
        ev = np.linalg.eigvals(w)
        ev = np.sort(np.abs(ev))[::-1]
        second = ev[1] if len(ev) > 1 else 0.0
        return float(1.0 - second)
    return power_iteration_gap(lambda x: w @ x, n, iters=iters, seed=seed)


def mixing_time(w, max_t: int = 100_000, method: str = "auto") -> Optional[int]:
    """tau_mix per paper eq. (5): first t with max_i ||e_i^T W^t - 1/N|| <= 1/2.

    Returns None when the chain is periodic / non-mixing (e.g. even ring),
    mirroring the paper's observation that tau_mix -> inf for ring topologies.

    Dense inputs up to _EXACT_SPECTRUM_MAX_N nodes use the exact repeated-
    product definition; sparse (``SparseW``) or larger inputs use the
    contraction bound t = ceil(ln 2 / -ln |lambda_2|), which suffices since
    ||e_i^T W^t - 1/N||_2 <= |lambda_2|^t ||e_i - 1/N||_2 <= |lambda_2|^t.
    """
    sparse_like = hasattr(w, "mix_host")
    n = w.n if sparse_like else np.asarray(w).shape[0]
    if (method != "bound" and not sparse_like
            and (method == "exact" or n <= _EXACT_SPECTRUM_MAX_N)):
        w = np.asarray(w)
        target = np.full((n, n), 1.0 / n)
        wt = np.eye(n)
        for t in range(1, max_t + 1):
            wt = wt @ w
            dev = np.linalg.norm(wt - target, axis=1).max()
            if dev <= 0.5:
                return t
            if t > 64 and dev > 0.999:  # not contracting at all
                break
        return None
    lam = 1.0 - spectral_gap(w, method="power")
    if lam >= 1.0 - 1e-12:
        return None
    t = int(np.ceil(np.log(2.0) / -np.log(lam)))
    return t if t <= max_t else None
