"""F-DOT (Alg. 2) and its distributed CholeskyQR: the port against the
reference on the same NumPy inputs (twins of ``tests/test_fdot.py``), the
port's fused loop against its eager oracle, and F-DOT over a sparse (ELL)
engine (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as jc
from repro.core import fdot as jfdot
from repro.core import topology as jtopo
from repro.core.linalg import eigh_topr, orthonormal_init as j_init
from repro.data.pipeline import gaussian_eigengap_data, partition_features
from repro_torch.core import fdot as tfdot
from repro_torch.core.consensus import SparseConsensus, consensus_schedule
from repro_torch.core.metrics import subspace_error
from repro_torch.interop import from_reference_arrays

TRACE_ATOL = 1e-5     # f32 on both sides; gossip and QR sum in another order
SPAN_TOL = 1e-5       # subspace error between two orthonormal bases
# q_full element by element: both sides compute the same iterate (CholeskyQR
# with a positive-diagonal R is unique), f32 sums in another order. Before
# consensus has converged q_full is not orthonormal, so the subspace error
# (which assumes orthonormal columns) cannot compare it.
Q_ATOL = 1e-5
LEDGER_FIELDS = ("p2p", "matrices", "scalars", "payload_bytes")


@pytest.fixture(scope="module")
def fprob():
    d, r, n_nodes = 20, 5, 10
    x, _, _ = gaussian_eigengap_data(d, 4000, r, 0.7, seed=0)
    _, q_true = eigh_topr(x @ x.T, r)
    return dict(d=d, r=r, n_nodes=n_nodes, x=x, q_true=q_true,
                blocks=partition_features(x, n_nodes),
                graph=jtopo.erdos_renyi(n_nodes, 0.5, seed=1),
                q_init=j_init(jax.random.PRNGKey(0), d, r))


def _port(graph, blocks, q_init, q_true=None, **extra):
    arrays = {"adjacency": graph.adjacency, "q_init": np.asarray(q_init),
              "slabs": [np.asarray(b) for b in blocks], **extra}
    if q_true is not None:
        arrays["q_true"] = np.asarray(q_true)
    return from_reference_arrays(arrays, device="cpu")


def _run_both(graph, blocks, q_init, q_true, r, **kw):
    """The reference's fused F-DOT and the port's fused and eager runs on
    the same inputs; asserts port fused == port eager (the reference's own
    fused-vs-eager tolerances) and returns (reference, port fused)."""
    ref = jfdot.fdot(data_blocks=blocks, engine=jc.DenseConsensus(graph),
                     r=r, q_init=q_init, q_true=q_true, **kw)
    st = _port(graph, blocks, q_init, q_true)
    port_kw = dict(data_blocks=st["data_blocks"], engine=st["engine"], r=r,
                   q_init=st["q_init"], q_true=st.get("q_true"),
                   device="cpu", **kw)
    fused = tfdot.fdot(fused=True, **port_kw)
    eager = tfdot.fdot(fused=False, **port_kw)
    if q_true is not None:
        np.testing.assert_allclose(fused.error_trace, eager.error_trace,
                                   rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(fused.q_full, eager.q_full, rtol=1e-4,
                               atol=1e-5)
    for field in LEDGER_FIELDS:
        assert getattr(fused.ledger, field) == getattr(eager.ledger, field)
    return ref, fused


def _assert_parity(port, ref):
    if ref.error_trace is not None:
        np.testing.assert_allclose(port.error_trace,
                                   np.asarray(ref.error_trace), rtol=0,
                                   atol=TRACE_ATOL)
    assert [b.shape[0] for b in port.q_blocks] == [b.shape[0]
                                                   for b in ref.q_blocks]
    np.testing.assert_allclose(port.q_full.numpy(), np.asarray(ref.q_full),
                               rtol=0, atol=Q_ATOL)
    for field in LEDGER_FIELDS:
        assert getattr(port.ledger, field) == getattr(ref.ledger, field)


def test_fdot_converges(fprob):
    p = fprob
    ref, port = _run_both(p["graph"], p["blocks"], p["q_init"], p["q_true"],
                          p["r"], t_outer=80, t_c=50)
    assert port.error_trace[-1] < 1e-5
    _assert_parity(port, ref)


def test_fdot_blocks_assemble_to_orthonormal(fprob):
    p = fprob
    ref, port = _run_both(p["graph"], p["blocks"], p["q_init"], None,
                          p["r"], t_outer=40, t_c=50)
    q = port.q_full
    torch.testing.assert_close(q.T @ q, torch.eye(p["r"]), rtol=0, atol=1e-3)
    _assert_parity(port, ref)


def test_fdot_uneven_feature_split(fprob):
    """d=20 over 7 nodes: the last node gets the remainder slab."""
    p = fprob
    blocks = partition_features(p["x"], 7)
    assert sum(b.shape[0] for b in blocks) == p["d"]
    ref, port = _run_both(jtopo.erdos_renyi(7, 0.6, seed=2), blocks,
                          p["q_init"], p["q_true"], p["r"], t_outer=80,
                          t_c=50)
    assert port.error_trace[-1] < 1e-5
    _assert_parity(port, ref)


def test_fdot_single_feature_per_node():
    """The paper's Fig. 6 setting: d == N, one feature per node."""
    n_nodes = 10
    x, _, _ = gaussian_eigengap_data(n_nodes, 2000, 3, 0.5, seed=5)
    _, q_true = eigh_topr(x @ x.T, 3)
    blocks = partition_features(x, n_nodes)
    assert all(b.shape[0] == 1 for b in blocks)
    ref, port = _run_both(jtopo.erdos_renyi(n_nodes, 0.5, seed=6), blocks,
                          j_init(jax.random.PRNGKey(4), n_nodes, 3), q_true,
                          3, t_outer=100, t_c=50)
    assert port.error_trace[-1] < 1e-5
    _assert_parity(port, ref)


def test_distributed_cholesky_qr_orthonormalizes(fprob):
    rng = np.random.default_rng(3)
    dims = [2, 3, 1, 4, 2, 3, 2, 1, 1, 1]
    v_np = [(rng.standard_normal((di, 4)) * 3.0).astype(np.float32)
            for di in dims]
    ref = jfdot.distributed_cholesky_qr([jnp.asarray(v) for v in v_np],
                                        jc.DenseConsensus(fprob["graph"]),
                                        t_c=120)
    eng = _port(fprob["graph"], fprob["blocks"], fprob["q_init"])["engine"]
    out = tfdot.distributed_cholesky_qr([torch.from_numpy(v) for v in v_np],
                                        eng, t_c=120)
    q = torch.cat(out)
    torch.testing.assert_close(q.T @ q, torch.eye(4), rtol=0, atol=1e-4)
    v = torch.from_numpy(np.concatenate(v_np))
    assert float(subspace_error(torch.linalg.qr(v)[0], q)) < 2e-6
    np.testing.assert_allclose(q.numpy(), np.asarray(jnp.concatenate(ref)),
                               rtol=0, atol=Q_ATOL)


def test_distributed_qr_single_pass_worse_than_two(fprob):
    rng = np.random.default_rng(4)
    # ill-conditioned V stresses CholeskyQR; pass 2 fixes orthogonality
    base = rng.standard_normal((20, 4))
    base[:, 3] = base[:, 0] + 1e-3 * base[:, 3]
    blocks = [torch.tensor(base[i * 2:(i + 1) * 2], dtype=torch.float32)
              for i in range(10)]
    eng = _port(fprob["graph"], fprob["blocks"], fprob["q_init"])["engine"]
    errs = {}
    for passes in (1, 2):
        port = torch.cat(tfdot.distributed_cholesky_qr(blocks, eng, t_c=200,
                                                       passes=passes))
        ref = torch.tensor(np.asarray(jnp.concatenate(
            jfdot.distributed_cholesky_qr(
                [jnp.asarray(b.numpy()) for b in blocks],
                jc.DenseConsensus(fprob["graph"]), t_c=200, passes=passes))))
        for side, q in (("port", port), ("ref", ref)):
            errs[side, passes] = float((q.T @ q - torch.eye(4)).abs().max())
    # cond(V) ~ 1e3 squares to 1e6 in the Gram, so f32 rounding in another
    # order moves Q (and even its span) by far more than 1e-5 on this input:
    # the two sides are held to the reference test's own properties
    for side in ("port", "ref"):
        assert errs[side, 2] <= errs[side, 1] + 1e-7
        assert errs[side, 2] < 1e-4


def test_fdot_ledger_counts(fprob):
    p = fprob
    ref, port = _run_both(p["graph"], p["blocks"], p["q_init"], None,
                          p["r"], t_outer=5, t_c=10)
    edges = p["graph"].adjacency.sum()
    # per outer iter: t_c rounds for the (n x r) product + 2 QR passes x t_c
    assert port.ledger.p2p == 5 * (10 + 2 * 10) * edges
    _assert_parity(port, ref)


@pytest.mark.parametrize("sched_kind", ["const", "lin2"])
def test_fdot_schedule_and_qr_budget_match_reference(fprob, sched_kind):
    """SA-style budgets for the partial products, a separate t_c_qr."""
    p = fprob
    sched = (None if sched_kind == "const"
             else jc.consensus_schedule("lin2", 20, cap=40))
    ref, port = _run_both(p["graph"], p["blocks"], p["q_init"], p["q_true"],
                          p["r"], t_outer=20, t_c=40, t_c_qr=30,
                          schedule=sched)
    _assert_parity(port, ref)


def test_fdot_on_sparse_engine_matches_reference():
    """F-DOT gossiping through a SparseConsensus (ELL rounds on both sides)."""
    n, d, r = 12, 24, 3
    x, _, _ = gaussian_eigengap_data(d, 1500, r, 0.6, seed=2)
    _, q_true = eigh_topr(x @ x.T, r)
    blocks = partition_features(x, n)
    g = jtopo.watts_strogatz(n, k=4, p=0.2, seed=3)
    q0 = j_init(jax.random.PRNGKey(2), d, r)
    eng = jc.SparseConsensus(g)
    ref = jfdot.fdot(data_blocks=blocks, engine=eng, r=r, t_outer=30,
                     t_c=40, q_init=q0, q_true=q_true)
    arrays = {k: np.asarray(getattr(eng._w, k))
              for k in ("ell_idx", "ell_val", "diag", "row_nnz")}
    st = _port(g, blocks, q0, q_true, **arrays)
    port_eng = SparseConsensus(st["graph"], device="cpu")
    port_eng._w = st["sparse_w"]
    kw = dict(data_blocks=st["data_blocks"], engine=port_eng, r=r,
              t_outer=30, t_c=40, q_init=st["q_init"], q_true=st["q_true"],
              device="cpu")
    port = tfdot.fdot(**kw)
    eager = tfdot.fdot(fused=False, **kw)
    np.testing.assert_allclose(port.error_trace, eager.error_trace,
                               rtol=1e-4, atol=1e-5)
    _assert_parity(port, ref)


def test_fdot_rejects_short_schedule_and_async_engines(fprob):
    p = fprob
    st = _port(p["graph"], p["blocks"], p["q_init"])
    kw = dict(data_blocks=st["data_blocks"], r=p["r"], t_outer=10,
              device="cpu")
    for fused in (True, False):
        with pytest.raises(ValueError, match="schedule"):
            tfdot.fdot(engine=st["engine"], schedule=np.array([5, 5]),
                       fused=fused, **kw)

    # async engines run now: fed the reference's own masks (three key
    # splits a step), F-DOT gives the reference's run; draws are refused
    # for a sync engine and when too few are given
    from repro.core.async_gossip import AsyncConsensus as JAsync
    from repro_torch.core.async_gossip import AsyncConsensus
    p_awake = np.full(p["n_nodes"], 0.8)
    ref = jfdot.fdot(data_blocks=p["blocks"], r=p["r"], t_outer=6, t_c=15,
                     engine=JAsync(p["graph"], p_awake, seed=1),
                     q_init=p["q_init"], q_true=p["q_true"])
    key, draws = jax.random.PRNGKey(1), []
    for _ in range(3 * 6):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.bernoulli(
            sub, jnp.asarray(p_awake, jnp.float32), (15, p["n_nodes"]))))
    st = _port(p["graph"], p["blocks"], p["q_init"], p["q_true"])
    kw = dict(kw, t_outer=6, t_c=15, q_init=st["q_init"],
              q_true=st["q_true"])
    with pytest.raises(ValueError, match="synchronous"):
        tfdot.fdot(engine=st["engine"], draws=draws, **kw)
    with pytest.raises(ValueError, match="injected draw"):
        tfdot.fdot(engine=AsyncConsensus(st["graph"], p_awake, seed=1,
                                         device="cpu"), draws=draws[:5], **kw)
    port = tfdot.fdot(engine=AsyncConsensus(st["graph"], p_awake, seed=1,
                                            device="cpu"), draws=draws, **kw)
    _assert_parity(port, ref)
    for field in ("p2p", "matrices", "scalars"):
        assert getattr(port.ledger, field) == getattr(ref.ledger, field)
    assert port.ledger.awake_counts == ref.ledger.awake_counts


def test_fdot_pad_helpers_match_reference(fprob):
    blocks = partition_features(fprob["x"][:, :50], 7)
    dims = [int(b.shape[0]) for b in blocks]
    t_blocks = [torch.tensor(np.asarray(b)) for b in blocks]
    stack = tfdot.pad_feature_slabs(t_blocks)
    np.testing.assert_array_equal(stack.numpy(),
                                  np.asarray(jfdot.pad_feature_slabs(blocks)))
    for a, b in zip(tfdot.unpad_feature_slabs(stack, dims), t_blocks):
        assert torch.equal(a, b)
    q = np.asarray(fprob["q_init"])
    np.testing.assert_array_equal(
        tfdot.split_pad_rows(torch.tensor(q), dims).numpy(),
        np.asarray(jfdot.split_pad_rows(jnp.asarray(q), dims)))
    assert consensus_schedule("lin2", 4, cap=5).tolist() == [3, 5, 5, 5]
