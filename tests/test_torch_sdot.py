"""The slice as a whole: port S-DOT/SA-DOT against the reference on the
``psa_problem`` shape (d=20, r=5, N=10, gap 0.7), dense and sparse, in
covariance, raw-data and ragged raw-data mode (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as jc
from repro.core import sdot as jsdot
from repro.core import topology as jtopo
from repro.core.linalg import eigh_topr as j_eigh, orthonormal_init as j_init
from repro.data.pipeline import gaussian_eigengap_data, partition_samples
from repro_torch.core import sdot as tsdot
from repro_torch.core.metrics import subspace_error
from repro_torch.interop import from_reference_arrays

TRACE_ATOL = 1e-5     # f32 on both sides; gossip and QR sum in another order
SPAN_TOL = 1e-5       # per-node subspace error between the two q_nodes


def _graph(topo, n):
    return jtopo.ring(n) if topo == "ring" else jtopo.erdos_renyi(n, 0.5,
                                                                  seed=1)


def _arrays(graph, q_init, q_true, covs=None, blocks=None, weights=None):
    arrays = {"adjacency": graph.adjacency, "q_init": np.asarray(q_init),
              "q_true": np.asarray(q_true)}
    if weights is not None:
        arrays["weights"] = weights
    if covs is not None:
        arrays["covs"] = np.asarray(covs)
    if blocks is not None:
        arrays["blocks"] = [np.asarray(b) for b in blocks]
    return arrays


def _assert_parity(port, ref):
    np.testing.assert_allclose(port.error_trace, np.asarray(ref.error_trace),
                               rtol=0, atol=TRACE_ATOL)
    per_node = torch.stack([
        subspace_error(torch.tensor(np.asarray(ref.q_nodes[i])),
                       port.q_nodes[i]) for i in range(port.q_nodes.shape[0])])
    assert float(per_node.max()) <= SPAN_TOL
    np.testing.assert_array_equal(port.consensus_trace, ref.consensus_trace)
    for field in ("p2p", "matrices", "scalars", "payload_bytes"):
        assert getattr(port.ledger, field) == getattr(ref.ledger, field)


def _fused_matches_eager(port_kw):
    fused = tsdot.sdot(**port_kw, fused=True)
    eager = tsdot.sdot(**port_kw, fused=False)
    # the reference's own fused-vs-eager tolerances (tests/test_sdot_fused.py)
    np.testing.assert_allclose(fused.error_trace, eager.error_trace,
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(fused.q_nodes, eager.q_nodes, rtol=1e-4,
                               atol=1e-5)
    for field in ("p2p", "matrices", "scalars", "payload_bytes"):
        assert getattr(fused.ledger, field) == getattr(eager.ledger, field)
    return fused


@pytest.mark.parametrize("mode", ["cov", "data"])
@pytest.mark.parametrize("sched_kind", ["const", "lin2"])
@pytest.mark.parametrize("topo", ["ring", "er"])
def test_sdot_matches_reference(psa_problem, topo, sched_kind, mode):
    p = psa_problem
    t_outer = 15
    q0 = j_init(jax.random.PRNGKey(3), p["d"], p["r"])
    sched = (None if sched_kind == "const"
             else jc.consensus_schedule("lin2", t_outer, cap=50))
    g = _graph(topo, p["n_nodes"])
    operand = ({"covs": p["covs"]} if mode == "cov"
               else {"data": p["blocks"]})
    ref = jsdot.sdot(engine=jc.DenseConsensus(g), r=p["r"], t_outer=t_outer,
                     schedule=sched, t_c=50, q_init=q0, q_true=p["q_true"],
                     **operand)
    st = from_reference_arrays(_arrays(
        g, q0, p["q_true"], covs=p["covs"] if mode == "cov" else None,
        blocks=p["blocks"] if mode == "data" else None), device="cpu")
    port_kw = dict(engine=st["engine"], r=p["r"], t_outer=t_outer,
                   schedule=sched, t_c=50, q_init=st["q_init"],
                   q_true=st["q_true"], device="cpu",
                   **({"covs": st["covs"]} if mode == "cov"
                      else {"data": st["data"]}))
    port = _fused_matches_eager(port_kw)
    _assert_parity(port, ref)


def test_sdot_ragged_raw_data_matches_reference():
    rng = np.random.default_rng(0)
    d, r, n = 12, 3, 10
    blocks = [rng.standard_normal((d, s)).astype(np.float32)
              for s in rng.integers(50, 200, size=n)]
    covs = jnp.stack([jnp.asarray(b @ b.T / b.shape[1]) for b in blocks])
    _, q_true = j_eigh(covs.sum(0), r)
    q0 = j_init(jax.random.PRNGKey(5), d, r)
    g = _graph("er", n)
    ref = jsdot.sdot(data=[jnp.asarray(b) for b in blocks],
                     engine=jc.DenseConsensus(g), r=r, t_outer=12, t_c=30,
                     q_init=q0, q_true=q_true)
    st = from_reference_arrays(_arrays(g, q0, q_true, blocks=blocks),
                               device="cpu")
    port = _fused_matches_eager(dict(
        data=st["data"], engine=st["engine"], r=r, t_outer=12, t_c=30,
        q_init=st["q_init"], q_true=st["q_true"], device="cpu"))
    _assert_parity(port, ref)


def test_sparse_sdot_matches_reference():
    """WS N=300: ``auto_sparse`` picks ELL gossip on both sides; the ELL
    arrays cross over through interop."""
    n, d, r = 300, 8, 2
    x, _, _ = gaussian_eigengap_data(d, n * 20, r, 0.7, seed=0)
    blocks = partition_samples(x, n)
    _, q_true = j_eigh(sum(b @ b.T / b.shape[1] for b in blocks), r)
    q0 = j_init(jax.random.PRNGKey(1), d, r)
    g = jtopo.watts_strogatz(n, k=6, p=0.1, seed=1)
    eng = jc.DenseConsensus(g)
    assert eng.is_sparse
    ref = jsdot.sadot(data=blocks, engine=eng, r=r, t_outer=6,
                      schedule_kind="lin2", cap=20, q_init=q0, q_true=q_true)
    arrays = _arrays(g, q0, q_true, blocks=blocks)
    arrays.update({k: np.asarray(getattr(eng._w, k))
                   for k in ("ell_idx", "ell_val", "diag", "row_nnz")})
    st = from_reference_arrays(arrays, device="cpu")
    assert st["engine"].is_sparse and st["engine"]._w is st["sparse_w"]
    port_kw = dict(data=st["data"], engine=st["engine"], r=r, t_outer=6,
                   schedule=jc.consensus_schedule("lin2", 6, cap=20),
                   q_init=st["q_init"], q_true=st["q_true"], device="cpu")
    port = _fused_matches_eager(port_kw)
    _assert_parity(port, ref)
    via_sadot = tsdot.sadot(schedule_kind="lin2", cap=20, **{
        k: v for k, v in port_kw.items() if k != "schedule"})
    np.testing.assert_array_equal(via_sadot.error_trace, port.error_trace)


def test_sdot_without_device_raises_where_no_card(psa_problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    p = psa_problem
    st = from_reference_arrays(_arrays(_graph("ring", p["n_nodes"]),
                                       np.eye(p["d"], p["r"]), p["q_true"],
                                       covs=p["covs"]), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsdot.sdot(covs=st["covs"], engine=st["engine"], r=p["r"], t_outer=2)


def test_async_engine_is_left_to_a_later_slice(psa_problem):
    """Async engines are no longer refused: S-DOT over an AsyncConsensus,
    fed the reference's own awake masks, gives the reference's run."""
    from repro.core.async_gossip import AsyncConsensus as JAsync
    from repro_torch.core.async_gossip import AsyncConsensus
    p = psa_problem
    g = _graph("ring", p["n_nodes"])
    q0 = j_init(jax.random.PRNGKey(4), p["d"], p["r"])
    p_awake = np.full(p["n_nodes"], 0.7)
    ref = jsdot.sdot(covs=p["covs"], engine=JAsync(g, p_awake, seed=2),
                     r=p["r"], t_outer=8, t_c=20, q_init=q0,
                     q_true=p["q_true"])
    key, draws = jax.random.PRNGKey(2), []
    for _ in range(8):                    # one key split an outer step
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.bernoulli(
            sub, jnp.asarray(p_awake, jnp.float32), (20, p["n_nodes"]))))
    st = from_reference_arrays(_arrays(g, q0, p["q_true"], covs=p["covs"]),
                               device="cpu")
    port = tsdot.sdot(covs=st["covs"], r=p["r"], t_outer=8, t_c=20,
                      engine=AsyncConsensus(st["graph"], p_awake, seed=2,
                                            device="cpu"),
                      q_init=st["q_init"], q_true=st["q_true"], device="cpu",
                      draws=draws)
    np.testing.assert_allclose(port.error_trace, np.asarray(ref.error_trace),
                               rtol=0, atol=TRACE_ATOL)
    for field in ("p2p", "matrices", "scalars"):
        assert getattr(port.ledger, field) == getattr(ref.ledger, field)
    assert port.ledger.awake_counts == ref.ledger.awake_counts


def test_data_generators_equal_reference():
    from repro.data import pipeline as jp
    from repro_torch.data import pipeline as tp
    for got, want in zip(tp.gaussian_eigengap_data(16, 300, 4, 0.7, seed=2,
                                                   device="cpu"),
                         jp.gaussian_eigengap_data(16, 300, 4, 0.7, seed=2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x_t = tp.spectrum_matched_data(12, 90, seed=1, device="cpu")
    x_j = jp.spectrum_matched_data(12, 90, seed=1)
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    for split in ("partition_samples", "partition_features"):
        for a, b in zip(getattr(tp, split)(x_t, 5), getattr(jp, split)(x_j, 5)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
