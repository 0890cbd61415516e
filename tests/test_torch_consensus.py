"""Port vs reference: dense and sparse gossip, the debias table, and the
consensus engine (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as jc
from repro.core import topology as jtopo
from repro_torch.core import consensus as tc
from repro_torch.core import topology as ttopo
from repro_torch.core.sparse import SparseW

TOL = dict(rtol=1e-5, atol=1e-6)   # f32 on both sides, another sum order

GRAPHS = {
    "ws": lambda m: m.watts_strogatz(300, k=4, p=0.1, seed=1),
    "ba": lambda m: m.barabasi_albert(300, m=3, seed=1),
    "rgg": lambda m: m.random_geometric(300, seed=1),
}


def _engines(kind, sparse):
    gj, gt = GRAPHS[kind](jtopo), GRAPHS[kind](ttopo)
    return (jc.DenseConsensus(gj, sparse=sparse),
            tc.DenseConsensus(gt, sparse=sparse, device="cpu"))


@pytest.fixture(scope="module")
def small_pair():
    return (jc.DenseConsensus(jtopo.erdos_renyi(12, 0.4, seed=2)),
            tc.DenseConsensus(ttopo.erdos_renyi(12, 0.4, seed=2),
                              device="cpu"))


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_sparse_arrays_equal_reference_where_auto_sparse_fires(kind):
    ej, et = _engines(kind, None)
    assert ej.is_sparse and et.is_sparse
    for field in ("ell_idx", "ell_val", "diag", "row_nnz"):
        np.testing.assert_array_equal(getattr(et._w, field).numpy(),
                                      np.asarray(getattr(ej._w, field)))
    assert et._w.ell_width == ej._w.ell_width
    assert (et._w.dense_off is None) == (ej._w.dense_off is None)
    for a, b in zip(et._w.csr(), ej._w.csr()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(et._w.to_dense().numpy(),
                                  np.asarray(ej._w.to_dense()))
    assert et._w.row_stats() == ej._w.row_stats()


@pytest.mark.parametrize("kind", sorted(GRAPHS))
@pytest.mark.parametrize("sparse", [True, False])
def test_gossip_mix_and_masked_gossip_match_reference(kind, sparse):
    ej, et = _engines(kind, sparse)
    z = np.random.default_rng(0).standard_normal((300, 4, 3)).astype(
        np.float32)
    got = tc.gossip_mix(et._w, torch.from_numpy(z)).numpy()
    want = np.asarray(jc.gossip_mix(ej._w, jnp.asarray(z)))
    np.testing.assert_allclose(got, want, **TOL)
    got = tc.masked_gossip(et._w, torch.from_numpy(z), 5, 9).numpy()
    want = np.asarray(jc.masked_gossip(ej._w, jnp.asarray(z), 5, 9))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", ["ws", "small"])
@pytest.mark.parametrize("sparse", [True, False])
def test_debias_table_matches_reference_and_matrix_power(kind, sparse,
                                                         small_pair):
    if kind == "small":
        gj, gt = small_pair[0].graph, small_pair[1].graph
        ej = jc.DenseConsensus(gj, sparse=sparse)
        et = tc.DenseConsensus(gt, sparse=sparse, device="cpu")
    else:
        ej, et = _engines(kind, sparse)
    t_max = 17
    got = et.debias_table(t_max).numpy()
    assert got.shape == (t_max + 1, et.graph.n_nodes)
    np.testing.assert_allclose(got, np.asarray(ej.debias_table(t_max)), **TOL)
    for t in (0, 1, 5, 17):
        np.testing.assert_allclose(got[t], tc.debias_weights(et.weights, t),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tc.debias_weights(et.weights, t),
                                      jc.debias_weights(ej.weights, t))


@pytest.mark.parametrize("sparse", [True, False])
def test_debiased_gossip_and_engine_runs_match_reference(sparse, small_pair):
    gj, gt = small_pair[0].graph, small_pair[1].graph
    ej = jc.DenseConsensus(gj, sparse=sparse)
    et = tc.DenseConsensus(gt, sparse=sparse, device="cpu")
    z = np.random.default_rng(3).standard_normal((12, 5, 2)).astype(
        np.float32)
    table_t, table_j = et.debias_table(20), ej.debias_table(20)
    got = tc.debiased_gossip(et._w, table_t, torch.from_numpy(z), 7, 20)
    want = jc.debiased_gossip(ej._w, table_j, jnp.asarray(z), 7, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        et.run_debiased_scan(torch.from_numpy(z), 7, t_max=20).numpy(),
        np.asarray(ej.run_debiased_scan(jnp.asarray(z), 7, t_max=20)), **TOL)
    np.testing.assert_allclose(
        et.run_debiased(torch.from_numpy(z), 9).numpy(),
        np.asarray(ej.run_debiased(jnp.asarray(z), 9)), **TOL)
    np.testing.assert_allclose(et.run(torch.from_numpy(z), 4).numpy(),
                               np.asarray(ej.run(jnp.asarray(z), 4)), **TOL)


@pytest.mark.parametrize("kind", ["const", "lin_half", "lin1", "lin2", "lin5"])
def test_consensus_schedule_equal(kind):
    np.testing.assert_array_equal(tc.consensus_schedule(kind, 30, cap=40),
                                  jc.consensus_schedule(kind, 30, cap=40))


def test_realized_round_weights_and_safe_scale_match_reference(small_pair):
    w = small_pair[0].weights.astype(np.float32)
    rng = np.random.default_rng(4)
    m = rng.random((12, 12)) < 0.6
    mask = m & m.T
    mask[3, :] = mask[:, 3] = False               # an isolated node
    off = ~np.eye(12, dtype=bool)
    got = tc.realized_round_weights(*(torch.from_numpy(a)
                                      for a in (w, mask, off)))
    want = jc.realized_round_weights(*(jnp.asarray(a) for a in (w, mask, off)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # the diagonal sums the dropped weights: 1 ulp from the summation order
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1.2e-7)
    assert got[1][3] == 1.0                       # isolated: exactly 1
    p = np.array([0.0, 1e-7, 0.3, 1.0], np.float32)
    np.testing.assert_array_equal(
        tc.safe_debias_scale(torch.from_numpy(p)).numpy(),
        np.asarray(jc.safe_debias_scale(jnp.asarray(p))))


def test_bf16_payload_engine_prices_two_bytes_and_quantises():
    g = ttopo.watts_strogatz(300, k=4, p=0.1, seed=1)
    eng = tc.SparseConsensus(g, payload_dtype="bfloat16", device="cpu")
    assert eng.is_sparse and eng.payload_bytes_per_elem == 2.0
    with pytest.raises(ValueError):
        tc.DenseConsensus(g, sparse=False, payload_dtype="bfloat16",
                          device="cpu")
    sw = SparseW.from_graph(g, device="cpu")
    z = torch.randn(300, 6, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(eng._w.mix(z), sw.mix(z))
    torch.testing.assert_close(eng._w.mix(z), sw.mix(z), rtol=0, atol=2e-2)


def test_engine_without_device_raises_where_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.DenseConsensus(ttopo.ring(5))
