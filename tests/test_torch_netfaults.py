"""Self-healing gossip under network faults in the port (core/netfaults.py)
against the reference (repro/core/netfaults.py), CPU.

Twins of ``tests/test_netfaults.py``: model validation, the degenerate
rounds (all links down, all nodes crashed, every payload corrupt) as exact
identities, realized round matrices, the rounds dense and ELL on the
reference's own draws, the port's fused rounds and runs against its eager
ones bit for bit, S-DOT and F-DOT on the reference's draws (replayed from
its key splits and injected), crash/freeze/rejoin, chunked resume, and the
sparse engine's slot-form draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import netfaults as jnf
from repro.core import topology as jtopo
from repro.core.fdot import fdot as jfdot
from repro.core.sdot import sdot as jsdot
from repro.data.pipeline import gaussian_eigengap_data
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.streaming import resume as jresume
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import runtime
from repro_torch.core.consensus import DenseConsensus, consensus_schedule
from repro_torch.core.fdot import fdot
from repro_torch.core.metrics import CommLedger, subspace_error
from repro_torch.core.netfaults import (FaultyConsensus, NetFaultModel,
                                        dense_to_slots, edge_slots,
                                        masked_faulty_rounds, slots_to_dense)
from repro_torch.core.sdot import sdot, sdot_program
from repro_torch.core.topology import Graph
from repro_torch.obs import Journal, read_journal, set_journal
from repro_torch.streaming import resume as tresume

D, R, N = 14, 3, 8
TRACE_ATOL = 1e-5     # f32 on both sides; gossip and QR sum in another order
SPAN_TOL = 1e-5       # per-node subspace error between two S-DOT iterates
Q_ATOL = 1e-5         # F-DOT q_full element by element
# a few rounds on the same draws, f32 both sides: 1e-6, relative to the
# mixed values and absolute near 0
ROUND_TOL = 1e-6
COUNT_FIELDS = ("p2p", "matrices", "scalars")
FAULTS = dict(p_drop=0.2, p_bad=0.05, p_good=0.5, p_corrupt=0.05)


def _ref_fault_draws(seed, n, t_max, calls):
    """The reference's fault blocks: one key split a gossip call
    (sdot.py / fdot.py's faulty bodies)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(calls):
        key, sub = jax.random.split(key)
        out.append(tuple(np.asarray(b) for b in
                         jnf.sample_fault_blocks(sub, n, t_max)))
    return out


def _top_r(m, r):
    return np.linalg.eigh(m)[1][:, ::-1][:, :r].astype(np.float32).copy()


@pytest.fixture(scope="module")
def prob():
    """Gap-0.7 data (the reference's generator), 60 samples a node."""
    rng = np.random.default_rng(1)
    x = np.asarray(gaussian_eigengap_data(D, 60 * N, R, 0.7, seed=1)[0])
    blocks = [x[:, 60 * i:60 * (i + 1)] for i in range(N)]
    covs = np.stack([b @ b.T / 60 for b in blocks]).astype(np.float32)
    return dict(
        x=x, blocks=blocks, covs=covs, q_true=_top_r(covs.sum(0), R),
        q_init=np.linalg.qr(rng.standard_normal((D, R)))[0].astype(np.float32),
        graph=jtopo.erdos_renyi(N, 0.5, seed=1))


def _engine(g, model=None, seed=0, **kw):
    return FaultyConsensus(Graph(g.adjacency),
                           NetFaultModel(**FAULTS) if model is None else model,
                           seed=seed, device="cpu", **kw)


def _z(n=N, d=6, r=2, seed=0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((n, d, r)).astype(np.float32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bad, field", [
    (dict(p_drop=1.5), "p_drop"),
    (dict(p_bad=-0.1), "p_bad"),
    (dict(p_bad=0.2, p_good=0.0), "p_good"),
    (dict(corrupt_mode="flip"), "corrupt_mode"),
    (dict(corrupt_scale=-1.0), "corrupt_scale"),
    (dict(guard_norm=0.0), "guard_norm"),
    (dict(crash_windows=((0, 2, 0),)), "crash_windows"),
    (dict(crash_windows=((-1, 2, 3),)), "crash_windows"),
])
def test_model_validation_names_field(bad, field):
    with pytest.raises(ValueError, match=field) as got:
        NetFaultModel(**bad).validate()
    with pytest.raises(ValueError) as want:
        jnf.NetFaultModel(**bad).validate()
    assert str(got.value) == str(want.value)


def test_model_validation_bounds_against_problem():
    with pytest.raises(ValueError, match="crash_windows"):
        NetFaultModel(crash_windows=((9, 0, 2),)).validate(n_nodes=8)
    with pytest.raises(ValueError, match="crash_windows"):
        NetFaultModel(crash_windows=((0, 10, 2),)).validate(n_nodes=8,
                                                            t_outer=5)


@pytest.mark.parametrize("mode", ["scale", "nan"])
def test_params_and_node_up_match_reference(mode):
    kw = dict(FAULTS, corrupt_mode=mode, crash_windows=((1, 2, 3), (0, 0, 1)))
    np.testing.assert_array_equal(NetFaultModel(**kw).params().numpy(),
                                  np.asarray(jnf.NetFaultModel(**kw).params()))
    up = NetFaultModel(**kw).node_up(6, 4)
    np.testing.assert_array_equal(up, jnf.NetFaultModel(**kw).node_up(6, 4))
    assert up[0, 0] == 0.0 and np.all(up[2:5, 1] == 0.0)
    assert np.all(up[:, 2:] == 1.0)


# ---------------------------------------------------------------------------
# degenerate rounds: the exact identity
# ---------------------------------------------------------------------------
def _graph(kind):
    return jtopo.ring(16) if kind == "ell" else jtopo.erdos_renyi(N, 0.5,
                                                                  seed=1)


@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_all_links_down_round_is_identity_with_zero_sends(kind):
    g = _graph(kind)
    eng = _engine(g, NetFaultModel(p_drop=1.0), seed=3,
                  sparse=kind == "ell")
    z0 = _z(n=g.n_nodes)
    ledger = CommLedger()
    out = eng.run_debiased(z0, 10, ledger)
    assert torch.equal(out, z0)
    assert ledger.p2p == 0.0 and ledger.scalars == 0.0


@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_all_nodes_crashed_round_is_identity(kind):
    g = _graph(kind)
    eng = _engine(g, seed=4, sparse=kind == "ell")
    z0 = _z(n=g.n_nodes, seed=4)
    out = eng.run_debiased(z0, 5, node_up=np.zeros(g.n_nodes, np.float32))
    assert torch.equal(out, z0)


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("mode", ["scale", "nan"])
def test_all_corrupt_degrades_to_identity(mode, kind):
    """A fully poisoned round degrades to a fully dropped one: the screen
    rejects every payload, nothing mixes, and no NaN reaches a product."""
    g = _graph(kind)
    eng = _engine(g, NetFaultModel(p_corrupt=1.0, corrupt_mode=mode),
                  seed=5, sparse=kind == "ell")
    z0 = _z(n=g.n_nodes, seed=5)
    ledger = CommLedger()
    out = eng.run_debiased(z0, 8, ledger)
    assert torch.equal(out, z0)
    assert ledger.p2p == 0.0


def test_realized_round_matrix_doubly_stochastic(prob):
    eng = _engine(prob["graph"])
    rng = np.random.default_rng(0)
    adj = np.asarray(eng.graph.adjacency, bool)
    ref = jnf.FaultyConsensus(prob["graph"])
    for _ in range(20):
        u = np.triu(rng.random((N, N)), 1)
        mask = adj & (u + u.T >= 0.4)
        w = eng.realized_round_matrix(mask)
        assert np.allclose(w.sum(0), 1.0, atol=1e-12)
        assert np.allclose(w.sum(1), 1.0, atol=1e-12)
        assert np.all(w >= 0.0)
        np.testing.assert_array_equal(w, ref.realized_round_matrix(mask))


# ---------------------------------------------------------------------------
# rounds on the reference's draws; execution modes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["scale", "nan"])
@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_masked_faulty_rounds_match_reference(kind, mode):
    g = jtopo.watts_strogatz(16, 4, 0.2, seed=3) if kind == "ell" else (
        jtopo.erdos_renyi(N, 0.5, seed=1))
    n = g.n_nodes
    kw = dict(FAULTS, p_corrupt=0.1, corrupt_mode=mode)
    je = jnf.FaultyConsensus(g, jnf.NetFaultModel(**kw), sparse=kind == "ell")
    eng = _engine(g, NetFaultModel(**kw), sparse=kind == "ell")
    blocks = _ref_fault_draws(5, n, 10, 1)[0]
    node_up = np.ones(n, np.float32)
    node_up[2] = 0.0
    z = _z(n=n, d=5, r=3, seed=2)
    ge = je._ge
    for call in range(2):                 # the burst state carries over
        want = jnf.masked_faulty_rounds(
            je._w, je._adj, je._params, jnp.asarray(node_up), ge,
            tuple(map(jnp.asarray, blocks)), jnp.int32(7),
            jnp.asarray(z.numpy()))
        got = masked_faulty_rounds(eng._w, eng._adj, eng._params,
                                   torch.tensor(node_up), eng._ge,
                                   eng._prepare(blocks), 7, z)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=ROUND_TOL, atol=ROUND_TOL)
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        ge, eng._ge = want[2], got[2]


def test_fused_rounds_match_eager_bitwise(prob):
    eng, eng2 = _engine(prob["graph"], seed=11), _engine(prob["graph"],
                                                         seed=11)
    z0 = _z(seed=1)
    node_up = torch.ones(N)
    node_up[2] = 0.0
    for _ in range(3):
        faults = eng.sample_faults(12, t_max=20)
        faults2 = eng2.sample_faults(12, t_max=20)
        fused = masked_faulty_rounds(eng._w, eng._adj, eng._params, node_up,
                                     eng._ge, faults, 12, z0)
        eager = eng2.run_rounds_eager(z0, node_up, faults2)
        for a, b in zip(fused, eager):
            assert torch.equal(a, b)
        eng._ge, eng2._ge = fused[2], eager[2]


def test_host_oracle_matches_device_rounds(prob):
    eng = _engine(prob["graph"], seed=2)
    host = _engine(prob["graph"], seed=2, fused=False)
    z0 = _z(seed=2)
    l_dev, l_host = CommLedger(), CommLedger()
    out_dev = eng.run_debiased(z0, 15, l_dev)
    out_host = host.run_debiased(z0, 15, l_host)
    torch.testing.assert_close(out_dev, out_host, rtol=1e-5, atol=1e-6)
    assert torch.equal(eng._ge, host._ge)
    assert l_dev == l_host


def test_realized_debias_consensus_converges_under_drops(prob):
    eng = _engine(prob["graph"], NetFaultModel(p_drop=0.3))
    z0 = _z()
    out = eng.run_debiased(z0, 300)
    assert float((out - z0.sum(0)[None]).abs().max()) < 1e-3


def test_padded_draws_slice_consistently(prob):
    """sample_faults(t_c, t_max) is the first t_c rounds of the padded
    draw of the engine's counter, and advances the counter by one."""
    eng = _engine(prob["graph"], seed=9)
    got = eng.sample_faults(12, t_max=20)
    full = _engine(prob["graph"], seed=9)._draw(0, 20)
    for a, b in zip(got, full):
        assert torch.equal(a, b[:12])
    assert eng._key.tolist() == [9, 1]
    assert full[0].shape == (20, N, N)
    assert torch.equal(full[0], full[0].transpose(1, 2))


def test_sparse_slot_draws_one_uniform_an_edge():
    """A sparse engine draws one uniform an undirected edge into both of
    its slots (0 in the padded slots); scattering to (T, N, N) and
    gathering back is exact, and the dense engine fed the scattered draws
    realizes the same masks."""
    g = jtopo.watts_strogatz(16, 4, 0.2, seed=3)
    eng = _engine(g, seed=1, sparse=True)
    dense = _engine(g, seed=1, sparse=False)
    u_drop, u_burst, u_cor = eng.sample_faults(10)
    assert u_drop.shape == (10, 16, eng._w.ell_width)
    pairs = edge_slots(eng._w)
    assert pairs.shape[1] == int(eng._w.row_nnz.sum()) // 2
    flat = u_drop.reshape(10, -1)
    assert torch.equal(flat[:, pairs[0]], flat[:, pairs[1]])
    padded = (torch.arange(eng._w.ell_width)[None, :]
              >= eng._w.row_nnz[:, None])
    assert not u_drop[:, padded].any()
    as_dense = [slots_to_dense(eng._w.ell_idx, u) for u in (u_drop, u_burst)]
    assert torch.equal(as_dense[0], as_dense[0].transpose(1, 2))
    assert torch.equal(dense_to_slots(eng._w.ell_idx, as_dense[0]), u_drop)
    z0 = _z(n=16, seed=3)
    l_s, l_d = CommLedger(), CommLedger()
    out_s = eng.run_debiased(z0, 10, l_s, faults=(u_drop, u_burst, u_cor))
    out_d = dense.run_debiased(z0, 10, l_d,
                               faults=(*as_dense, u_cor))
    torch.testing.assert_close(out_s, out_d, rtol=1e-5, atol=1e-5)
    assert l_s == l_d


# ---------------------------------------------------------------------------
# S-DOT / F-DOT under faults
# ---------------------------------------------------------------------------
def _sdot_kw(prob, **kw):
    base = dict(covs=torch.tensor(prob["covs"]), r=R, t_outer=6,
                q_init=torch.tensor(prob["q_init"]),
                q_true=torch.tensor(prob["q_true"]), device="cpu")
    base.update(kw)
    return base


@pytest.mark.parametrize("debias", ["realized", "nominal"])
@pytest.mark.parametrize("sched_kind", ["const", "lin2"])
@pytest.mark.parametrize("topo", ["ring", "er"])
def test_sdot_faulty_matches_reference(prob, topo, sched_kind, debias):
    g = jtopo.ring(N) if topo == "ring" else prob["graph"]
    kw = dict(FAULTS, crash_windows=((0, 2, 2),), corrupt_mode="nan")
    sched = consensus_schedule(sched_kind, 6, t_max=8, cap=8)
    ref = jsdot(covs=jnp.asarray(prob["covs"]),
                engine=jnf.FaultyConsensus(g, jnf.NetFaultModel(**kw),
                                           seed=7, debias=debias),
                r=R, t_outer=6, schedule=sched,
                q_init=jnp.asarray(prob["q_init"]),
                q_true=jnp.asarray(prob["q_true"]))
    draws = _ref_fault_draws(7, N, int(sched.max()), 6)
    port = sdot(engine=_engine(g, NetFaultModel(**kw), seed=7,
                               debias=debias), draws=draws,
                **_sdot_kw(prob, schedule=sched))
    np.testing.assert_allclose(port.error_trace, np.asarray(ref.error_trace),
                               rtol=0, atol=TRACE_ATOL)
    q_ref = torch.tensor(np.asarray(ref.q_nodes))
    assert float(subspace_error(q_ref, port.q_nodes).max()) <= SPAN_TOL
    for f in COUNT_FIELDS:
        assert getattr(port.ledger, f) == getattr(ref.ledger, f)
    assert port.ledger.awake_counts == ref.ledger.awake_counts
    assert port.ledger.payload_bytes == 4 * port.ledger.scalars


@pytest.mark.parametrize("with_draws", [False, True])
def test_sdot_faulty_fused_equals_eager_bitwise(prob, with_draws):
    """Fused and eager S-DOT draw the same padded blocks (the engine's own,
    or injected) and give the same bits: iterate, trace, ledger, and the
    engine's counter and burst state afterwards."""
    kw = dict(FAULTS, crash_windows=((3, 1, 2),))
    sched = consensus_schedule("lin2", 6, cap=10)
    draws = _ref_fault_draws(3, N, 10, 6) if with_draws else None
    e1 = _engine(prob["graph"], NetFaultModel(**kw), seed=3)
    e2 = _engine(prob["graph"], NetFaultModel(**kw), seed=3)
    fused = sdot(engine=e1, draws=draws, **_sdot_kw(prob, schedule=sched))
    eager = sdot(engine=e2, draws=draws, fused=False,
                 **_sdot_kw(prob, schedule=sched))
    assert torch.equal(fused.q_nodes, eager.q_nodes)
    np.testing.assert_array_equal(fused.error_trace, eager.error_trace)
    assert fused.ledger == eager.ledger
    assert e1._key.tolist() == e2._key.tolist() == [3, 6]
    assert torch.equal(e1._ge, e2._ge)


def test_sdot_faultfree_matches_sync(prob):
    kw = _sdot_kw(prob, t_outer=10, t_c=20)
    sync = sdot(engine=DenseConsensus(Graph(prob["graph"].adjacency),
                                      device="cpu"), **kw)
    res = sdot(engine=_engine(prob["graph"], NetFaultModel()), **kw)
    np.testing.assert_allclose(res.error_trace, sync.error_trace, rtol=0,
                               atol=1e-5)
    for f in COUNT_FIELDS + ("payload_bytes",):
        assert getattr(res.ledger, f) == getattr(sync.ledger, f)


def test_sdot_crashed_node_freezes_then_rejoins(tmp_path, prob):
    """Node 0 is down in steps 3-5: its iterate after step 6 equals its
    iterate after step 3 bit for bit (read from one chunked run stopped at
    step 3 and resumed to 6), and after rejoining it re-converges (the
    crash alone, as in the reference's twin of this test)."""
    model = NetFaultModel(crash_windows=((0, 3, 3),))
    kw = _sdot_kw(prob, t_outer=30, t_c=10)
    mgr = CheckpointManager(str(tmp_path))
    at3 = runtime.run_chunked(sdot_program(engine=_engine(
        prob["graph"], model, seed=1), **kw), mgr, chunk_size=10,
        target_step=3)
    at6 = runtime.run_chunked(sdot_program(engine=_engine(
        prob["graph"], model, seed=1), **kw), mgr, chunk_size=10,
        target_step=6)
    assert torch.equal(at3.q_nodes[0], at6.q_nodes[0])
    assert not torch.equal(at3.q_nodes[1], at6.q_nodes[1])
    res = sdot(engine=_engine(prob["graph"], model, seed=1), **kw)
    np.testing.assert_array_equal(res.error_trace[:6], at6.error_trace)
    assert res.error_trace[-1] < 1e-4


def test_fdot_faulty_matches_reference(prob):
    x = prob["x"]
    slabs = [x[:4], x[4:8], x[8:11], x[11:]]
    g4 = jtopo.erdos_renyi(4, 0.9, seed=1)
    q_true = _top_r(x @ x.T, R)
    kw = dict(p_drop=0.15, p_bad=0.05, p_good=0.5, crash_windows=((1, 1, 2),))
    ref = jfdot(data_blocks=[jnp.asarray(s) for s in slabs],
                engine=jnf.FaultyConsensus(g4, jnf.NetFaultModel(**kw),
                                           seed=2), r=R, t_outer=5, t_c=8,
                q_init=jnp.asarray(prob["q_init"]), q_true=jnp.asarray(q_true))
    draws = _ref_fault_draws(2, 4, 8, 3 * 5)
    fkw = dict(data_blocks=[torch.tensor(s) for s in slabs], r=R, t_outer=5,
               t_c=8, q_init=torch.tensor(prob["q_init"]),
               q_true=torch.tensor(q_true), device="cpu", draws=draws)
    fused = fdot(engine=_engine(g4, NetFaultModel(**kw), seed=2), **fkw)
    eager = fdot(engine=_engine(g4, NetFaultModel(**kw), seed=2),
                 fused=False, **fkw)
    for res in (fused, eager):
        np.testing.assert_allclose(res.error_trace,
                                   np.asarray(ref.error_trace), rtol=0,
                                   atol=TRACE_ATOL)
        np.testing.assert_allclose(res.q_full.numpy(), np.asarray(ref.q_full),
                                   rtol=0, atol=Q_ATOL)
        for f in COUNT_FIELDS:
            assert getattr(res.ledger, f) == getattr(ref.ledger, f)
        assert res.ledger.awake_counts == ref.ledger.awake_counts
    assert fused.ledger == eager.ledger


@pytest.mark.parametrize("family", ["sdot", "fdot"])
def test_faulty_chunked_resume_bitwise(tmp_path, prob, family):
    """Killed after one chunk and resumed on the same directory: trace,
    iterate, ledger (with awake counts), burst state and counter equal the
    uninterrupted run's bit for bit."""
    model = NetFaultModel(**FAULTS, crash_windows=((1, 2, 3),))
    if family == "sdot":
        kw = _sdot_kw(prob, t_outer=9, t_c=12)
        g, chunked, whole, q_attr = (prob["graph"], tresume.sdot_chunked,
                                     sdot, "q_nodes")
    else:
        x = prob["x"]
        kw = dict(data_blocks=[torch.tensor(x[i::3]) for i in range(3)],
                  r=R, t_outer=9, t_c=12, q_init=torch.tensor(prob["q_init"]),
                  device="cpu")
        g, chunked, whole, q_attr = (jtopo.complete(3), tresume.fdot_chunked,
                                     fdot, "q_full")
    e_mono = _engine(g, model, seed=5)
    mono = whole(engine=e_mono, **kw)
    mgr = CheckpointManager(str(tmp_path))
    chunked(engine=_engine(g, model, seed=5), chunk_size=4, manager=mgr,
            max_chunks=1, **kw)
    e_res = _engine(g, model, seed=5)
    res = chunked(engine=e_res, chunk_size=4, manager=mgr, **kw)
    if mono.error_trace is not None:
        np.testing.assert_array_equal(res.error_trace, mono.error_trace)
    assert torch.equal(getattr(res, q_attr), getattr(mono, q_attr))
    assert res.ledger == mono.ledger
    assert torch.equal(e_res._ge, e_mono._ge)
    assert e_res._key.tolist() == e_mono._key.tolist()


def test_sparse_sdot_faulty_matches_reference():
    """A forced-sparse ring: the reference's dense draws, gathered at the
    ELL slots, give the reference's sparse run; a bf16-payload run is
    finite and priced at 2 bytes an element."""
    n, d, r = 16, 8, 2
    rng = np.random.default_rng(2)
    x = rng.standard_normal((d, 40 * n)).astype(np.float32)
    blocks = [x[:, 40 * i:40 * (i + 1)] for i in range(n)]
    q_true = _top_r(x @ x.T, r)
    q0 = np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
    g = jtopo.ring(n)
    model = dict(p_drop=0.1, p_bad=0.05, p_good=0.5, p_corrupt=0.02,
                 corrupt_mode="nan")
    ref = jsdot(data=[jnp.asarray(b) for b in blocks],
                engine=jnf.FaultyConsensus(g, jnf.NetFaultModel(**model),
                                           seed=4, sparse=True),
                r=r, t_outer=5, t_c=10, q_init=jnp.asarray(q0),
                q_true=jnp.asarray(q_true))
    kw = dict(data=[torch.tensor(b) for b in blocks], r=r, t_outer=5, t_c=10,
              q_init=torch.tensor(q0), q_true=torch.tensor(q_true),
              device="cpu")
    eng = _engine(g, NetFaultModel(**model), seed=4, sparse=True)
    assert eng.is_sparse
    port = sdot(engine=eng, draws=_ref_fault_draws(4, n, 10, 5), **kw)
    np.testing.assert_allclose(port.error_trace, np.asarray(ref.error_trace),
                               rtol=0, atol=TRACE_ATOL)
    for f in COUNT_FIELDS:
        assert getattr(port.ledger, f) == getattr(ref.ledger, f)
    assert port.ledger.awake_counts == ref.ledger.awake_counts
    bf = sdot(engine=_engine(g, NetFaultModel(**model), seed=4, sparse=True,
                             payload_dtype="bfloat16"), **kw)
    assert np.isfinite(bf.error_trace).all()
    assert bf.ledger.payload_bytes == 2 * bf.ledger.scalars


def test_reference_faulty_checkpoint_refused(tmp_path, prob):
    g = prob["graph"]
    model = dict(p_drop=0.2)
    jresume.sdot_chunked(engine=jnf.FaultyConsensus(
        g, jnf.NetFaultModel(**model), seed=1), chunk_size=4,
        manager=JManager(str(tmp_path)), max_chunks=1,
        covs=jnp.asarray(prob["covs"]), r=R, t_outer=8, t_c=10,
        q_init=jnp.asarray(prob["q_init"]))
    prog = sdot_program(engine=_engine(g, NetFaultModel(**model), seed=1),
                        **_sdot_kw(prob, t_outer=8, t_c=10, q_true=None))
    with pytest.raises(ValueError, match="JAX reference"):
        runtime.run_chunked(prog, CheckpointManager(str(tmp_path)),
                            chunk_size=4)


def test_engine_journals_its_fault_model(tmp_path, prob):
    journal = set_journal(Journal.open(str(tmp_path), "run"))
    try:
        _engine(prob["graph"], NetFaultModel(p_drop=0.3), seed=6)
    finally:
        journal.close()
        set_journal(Journal.noop())
    recs = [r for r in read_journal(journal.path)
            if r["name"] == "netfault_model"]
    assert len(recs) == 1 and recs[0]["phase"] == "chaos"
    assert recs[0]["p_drop"] == pytest.approx(0.3) and recs[0]["seed"] == 6
