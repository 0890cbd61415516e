"""Port vs reference: topology generators, weight rules, spectral helpers,
subspace metrics and the communication ledger (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.core import topology as jtopo
from repro_torch.core import metrics as tmetrics
from repro_torch.core import topology as ttopo

GENERATORS = {
    "er": lambda m, s: m.erdos_renyi(24, 0.2, seed=s),
    "ring": lambda m, s: m.ring(7 + s),
    "star": lambda m, s: m.star(6 + s),
    "torus": lambda m, s: m.torus2d(3, 4 + s),
    "complete": lambda m, s: m.complete(5 + s),
    "ws": lambda m, s: m.watts_strogatz(40, k=4, p=0.2, seed=s),
    "ba": lambda m, s: m.barabasi_albert(40, m=2, seed=s),
    "rgg": lambda m, s: m.random_geometric(40, seed=s),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(GENERATORS))
def test_generators_and_weights_equal_reference(kind, seed):
    gj = GENERATORS[kind](jtopo, seed)
    gt = GENERATORS[kind](ttopo, seed)
    np.testing.assert_array_equal(gt.adjacency, gj.adjacency)
    np.testing.assert_array_equal(ttopo.local_degree_weights(gt),
                                  jtopo.local_degree_weights(gj))
    np.testing.assert_array_equal(ttopo.metropolis_weights(gt),
                                  jtopo.metropolis_weights(gj))


@pytest.mark.parametrize("kind", ["er", "ring", "ws"])
def test_spectral_helpers_equal_reference(kind):
    w_j = jtopo.local_degree_weights(GENERATORS[kind](jtopo, 0))
    w_t = ttopo.local_degree_weights(GENERATORS[kind](ttopo, 0))
    assert ttopo.spectral_gap(w_t) == jtopo.spectral_gap(w_j)
    assert ttopo.mixing_time(w_t) == jtopo.mixing_time(w_j)
    assert (ttopo.spectral_gap(w_t, method="power", iters=200)
            == jtopo.spectral_gap(w_j, method="power", iters=200))
    assert (ttopo.mixing_time(w_t, method="bound")
            == jtopo.mixing_time(w_j, method="bound"))


def _orthonormal(rng, *shape):
    return np.linalg.qr(rng.standard_normal(shape))[0].astype(np.float32)


def test_subspace_errors_match_reference():
    """Tolerance 1e-6: both are f32 SVDs of the same r x r cross products."""
    rng = np.random.default_rng(0)
    d, r, n = 16, 4, 6
    q_true = _orthonormal(rng, d, r)
    q_nodes = np.stack([_orthonormal(rng, d, r) for _ in range(n)])
    q_nodes[0] = q_true @ _orthonormal(rng, r, r)       # same span: error 0
    for i in range(n):
        want = float(jmetrics.subspace_error(jnp.asarray(q_true),
                                             jnp.asarray(q_nodes[i])))
        got = float(tmetrics.subspace_error(torch.from_numpy(q_true),
                                            torch.from_numpy(q_nodes[i])))
        assert abs(got - want) <= 1e-6
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    for m in (None, mask):
        want = float(jmetrics.mean_subspace_error(
            jnp.asarray(q_true), jnp.asarray(q_nodes),
            None if m is None else jnp.asarray(m)))
        got = float(tmetrics.mean_subspace_error(
            torch.from_numpy(q_true), torch.from_numpy(q_nodes),
            None if m is None else torch.from_numpy(m)))
        assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("bytes_per_elem", [4.0, 2.0])
def test_comm_ledger_fields_equal(bytes_per_elem):
    adj = jtopo.erdos_renyi(12, 0.4, seed=3).adjacency
    sched = np.array([3, 5, 7, 50])
    lj, lt = jmetrics.CommLedger(), tmetrics.CommLedger()
    for _ in sched:
        lj.log_gossip_round(adj, 35, bytes_per_elem)
        lt.log_gossip_round(adj, 35, bytes_per_elem)
    lj.log_gossip_rounds(sched, adj, 35, bytes_per_elem)
    lt.log_gossip_rounds(sched, adj, 35, bytes_per_elem)
    for field in ("p2p", "matrices", "scalars", "payload_bytes"):
        assert getattr(lt, field) == getattr(lj, field)
    assert lt.per_node_p2p(12) == lj.per_node_p2p(12)
    assert (tmetrics.p2p_per_consensus_round(adj)
            == jmetrics.p2p_per_consensus_round(adj))
