"""Asynchronous gossip in the port (core/async_gossip.py) against the
reference (repro/core/async_gossip.py), CPU.

Twins of ``tests/test_async_gossip.py``: realized round matrices, the
degenerate all-asleep round, the rounds and whole S-DOT/F-DOT runs on the
reference's own awake masks (replayed from its key splits and injected),
the port's fused run against its eager loop bit for bit, chunked resume,
and the straggler wall-clock model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import async_gossip as jag
from repro.core import topology as jtopo
from repro.core.bdot import bdot as jbdot
from repro.core.fdot import fdot as jfdot
from repro.core.sdot import sdot as jsdot
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.streaming import resume as jresume
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import runtime
from repro_torch.core.async_gossip import (AsyncConsensus, GossipDraws,
                                           async_round_weights,
                                           draw_generator,
                                           masked_async_rounds,
                                           straggler_wall_clock)
from repro_torch.core.bdot import bdot
from repro_torch.core.consensus import DenseConsensus, consensus_schedule
from repro_torch.core.fdot import fdot
from repro_torch.core.metrics import CommLedger, subspace_error
from repro_torch.core.sdot import sdot, sdot_program
from repro_torch.core.topology import Graph
from repro_torch.streaming import resume as tresume

D, R, N = 14, 3, 8
TRACE_ATOL = 1e-5     # f32 on both sides; gossip and QR sum in another order
SPAN_TOL = 1e-5       # per-node subspace error between two S-DOT iterates
Q_ATOL = 1e-5         # F-DOT q_full element by element
# a few rounds on the same masks, f32 both sides: 1e-6, relative to the
# debiased values (about N times the payload's) and absolute near 0
ROUND_TOL = 1e-6
COUNT_FIELDS = ("p2p", "matrices", "scalars")


def _ref_awake_draws(seed, p_awake, n, t_max, calls):
    """The reference's awake blocks: one key split a gossip call, each a
    (t_max, N) Bernoulli draw (sdot.py / fdot.py's async bodies)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(calls):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.bernoulli(
            sub, jnp.asarray(p_awake, jnp.float32), (t_max, n))))
    return out


def _top_r(m, r):
    return np.linalg.eigh(m)[1][:, ::-1][:, :r].astype(np.float32).copy()


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((D, 60 * N)).astype(np.float32)
    blocks = [x[:, 60 * i:60 * (i + 1)] for i in range(N)]
    covs = np.stack([b @ b.T / 60 for b in blocks]).astype(np.float32)
    return dict(
        x=x, blocks=blocks, covs=covs, q_true=_top_r(covs.sum(0), R),
        q_init=np.linalg.qr(rng.standard_normal((D, R)))[0].astype(np.float32),
        graph=jtopo.erdos_renyi(N, 0.5, seed=1))


def _engine(g, p_awake, seed=0, **kw):
    return AsyncConsensus(Graph(g.adjacency), p_awake, seed=seed,
                          device="cpu", **kw)


def _z(n=N, d=6, r=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d, r)).astype(np.float32)


# ---------------------------------------------------------------------------
# realized rounds
# ---------------------------------------------------------------------------
def test_round_matrix_doubly_stochastic(prob):
    eng = _engine(prob["graph"], 0.6)
    for _ in range(20):
        w, awake = eng._round_matrix()
        assert np.allclose(w.sum(0), 1.0, atol=1e-12)
        assert np.allclose(w.sum(1), 1.0, atol=1e-12)
        for i in np.nonzero(~awake)[0]:          # sleepers do not mix
            assert w[i, i] == pytest.approx(1.0)
    masks = torch.rand((20, N), generator=torch.Generator().manual_seed(1))
    rounds = async_round_weights(eng._w, masks < 0.6)
    torch.testing.assert_close(rounds.sum(1), torch.ones((20, N)),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(rounds.sum(2), torch.ones((20, N)),
                               rtol=0, atol=1e-6)
    assert torch.equal(rounds, rounds.transpose(1, 2))
    for t in range(20):
        np.testing.assert_allclose(
            rounds[t].numpy(), eng._apply_mask((masks[t] < 0.6).numpy()),
            rtol=0, atol=1e-7)


@pytest.mark.parametrize("fused", [True, False])
def test_all_asleep_rounds_are_exact_identity(prob, fused):
    """Nobody awake: every round is the exact identity, zero sends, and the
    debias guard never divides by ~0, so the input comes back bit for
    bit."""
    eng = _engine(prob["graph"], 0.0, fused=fused)
    z0 = torch.tensor(_z(seed=6))
    ledger = CommLedger()
    out = eng.run_debiased(z0, 25, ledger)
    assert torch.equal(out, z0)
    assert ledger.p2p == 0.0 and ledger.scalars == 0.0
    assert ledger.awake_counts and max(ledger.awake_counts) == 0


@pytest.mark.parametrize("t_c", [7, 12])
@pytest.mark.parametrize("topo", ["ring", "er"])
def test_masked_async_rounds_match_reference(prob, topo, t_c):
    g = jtopo.ring(N) if topo == "ring" else prob["graph"]
    awake = _ref_awake_draws(5, np.full(N, 0.6), N, 12, 1)[0]
    z = _z(seed=2)
    je = jag.AsyncConsensus(g, p_awake=0.6)
    want = jag.masked_async_rounds(je._w, je._adj, jnp.asarray(awake),
                                   jnp.int32(t_c), jnp.asarray(z))
    eng = _engine(g, 0.6)
    got = masked_async_rounds(eng._w, eng._adj, torch.tensor(awake), t_c,
                              torch.tensor(z))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=ROUND_TOL, atol=ROUND_TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_async_consensus_converges_to_sum(prob):
    z0 = torch.tensor(_z())
    out = _engine(prob["graph"], 0.7).run_debiased(z0, 300)
    assert float((out - z0.sum(0)[None]).abs().max()) < 1e-4


def test_host_oracle_matches_fused_on_identical_masks(prob):
    awake = _ref_awake_draws(1, np.full(N, 0.5), N, 30, 1)[0]
    z0 = torch.tensor(_z(seed=3))
    l_dev, l_host = CommLedger(), CommLedger()
    dev = _engine(prob["graph"], 0.5).run_debiased(z0, 30, l_dev,
                                                   awake=awake)
    host = _engine(prob["graph"], 0.5, fused=False).run_debiased(
        z0, 30, l_host, awake=awake)
    torch.testing.assert_close(dev, host, rtol=1e-5, atol=1e-5)
    assert l_dev == l_host
    ref = jag.AsyncConsensus(prob["graph"], p_awake=0.5, fused=False)
    want = ref.run_debiased(jnp.asarray(z0.numpy()), 30, awake=awake)
    np.testing.assert_allclose(host.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_draws_are_a_pure_function_of_seed_and_counter(prob):
    """The port's stream: a draw depends on (seed, counter, padded shape)
    alone; sample_awake(t_c, t_max) is the first t_c rows of the padded
    draw, and each call advances the counter by one."""
    eng = _engine(prob["graph"], 0.5, seed=9)
    first = eng.sample_awake(12, t_max=20)
    assert eng._key.tolist() == [9, 1]
    again = _engine(prob["graph"], 0.5, seed=9)._draw(0, 20)
    assert torch.equal(first, again[:12])
    second = eng.sample_awake(12, t_max=20)
    assert not torch.equal(first, second)
    u = torch.rand(5, generator=draw_generator(9, 1, torch.device("cpu")))
    v = torch.rand(5, generator=draw_generator(9, 1, torch.device("cpu")))
    assert torch.equal(u, v)
    source = GossipDraws.of(eng, [first])
    block, key = source.take(eng._key, 20)
    assert torch.equal(block, first) and key.tolist() == [9, 3]
    with pytest.raises(ValueError, match="injected draw 1"):
        source.take(key, 20)


# ---------------------------------------------------------------------------
# S-DOT / F-DOT / B-DOT over async engines
# ---------------------------------------------------------------------------
def _sdot_pair(prob, mode, sched, p_awake, seed, t_outer=8, t_c=20):
    """The reference's fused async S-DOT and the port's kwargs fed its
    draws."""
    operand_ref = ({"covs": jnp.asarray(prob["covs"])} if mode == "cov"
                   else {"data": [jnp.asarray(b) for b in prob["blocks"]]})
    ref = jsdot(engine=jag.AsyncConsensus(prob["graph"], p_awake, seed=seed),
                r=R, t_outer=t_outer, t_c=t_c, schedule=sched,
                q_init=jnp.asarray(prob["q_init"]),
                q_true=jnp.asarray(prob["q_true"]), **operand_ref)
    t_max = int(np.max(sched[:t_outer])) if sched is not None else t_c
    draws = _ref_awake_draws(seed, p_awake, N, t_max, t_outer)
    operand = ({"covs": torch.tensor(prob["covs"])} if mode == "cov"
               else {"data": [torch.tensor(b) for b in prob["blocks"]]})
    kw = dict(r=R, t_outer=t_outer, t_c=t_c, schedule=sched,
              q_init=torch.tensor(prob["q_init"]),
              q_true=torch.tensor(prob["q_true"]), device="cpu", **operand)
    return ref, kw, draws


def _assert_sdot_parity(port, ref):
    np.testing.assert_allclose(port.error_trace, np.asarray(ref.error_trace),
                               rtol=0, atol=TRACE_ATOL)
    q_ref = torch.tensor(np.asarray(ref.q_nodes))
    assert float(subspace_error(q_ref, port.q_nodes).max()) <= SPAN_TOL
    for f in COUNT_FIELDS:
        assert getattr(port.ledger, f) == getattr(ref.ledger, f)
    assert port.ledger.awake_counts == ref.ledger.awake_counts


@pytest.mark.parametrize("mode", ["cov", "data"])
@pytest.mark.parametrize("sched_kind", ["const", "lin2"])
def test_sdot_async_matches_reference(prob, sched_kind, mode):
    sched = (None if sched_kind == "const"
             else consensus_schedule("lin2", 8, cap=20))
    p_awake = np.full(N, 0.75)
    p_awake[0] = 1 / 11
    ref, kw, draws = _sdot_pair(prob, mode, sched, p_awake, seed=4)
    fused = sdot(engine=_engine(prob["graph"], p_awake, 4), draws=draws,
                 **kw)
    eager = sdot(engine=_engine(prob["graph"], p_awake, 4), draws=draws,
                 fused=False, **kw)
    _assert_sdot_parity(fused, ref)
    assert torch.equal(fused.q_nodes, eager.q_nodes)
    np.testing.assert_array_equal(fused.error_trace, eager.error_trace)
    assert fused.ledger == eager.ledger


def test_sdot_async_fused_equals_eager_bitwise(prob):
    """The port's own stream: a seeded eager run draws the fused run's
    padded blocks and gives its bits, and leaves the engine's counter where
    the fused run leaves it."""
    kw = dict(covs=torch.tensor(prob["covs"]), r=R, t_outer=7,
              schedule=consensus_schedule("lin2", 7, cap=12),
              q_init=torch.tensor(prob["q_init"]),
              q_true=torch.tensor(prob["q_true"]), device="cpu")
    e1, e2 = _engine(prob["graph"], 0.6, 3), _engine(prob["graph"], 0.6, 3)
    fused, eager = sdot(engine=e1, **kw), sdot(engine=e2, fused=False, **kw)
    assert torch.equal(fused.q_nodes, eager.q_nodes)
    np.testing.assert_array_equal(fused.error_trace, eager.error_trace)
    assert fused.ledger == eager.ledger
    assert e1._key.tolist() == e2._key.tolist() == [3, 7]


def test_sdot_all_awake_matches_sync(prob):
    kw = dict(covs=torch.tensor(prob["covs"]), r=R, t_outer=10, t_c=20,
              q_init=torch.tensor(prob["q_init"]),
              q_true=torch.tensor(prob["q_true"]), device="cpu")
    sync = sdot(engine=DenseConsensus(Graph(prob["graph"].adjacency),
                                      device="cpu"), **kw)
    res = sdot(engine=_engine(prob["graph"], 1.0), **kw)
    np.testing.assert_allclose(res.error_trace, sync.error_trace, rtol=0,
                               atol=1e-5)
    for f in COUNT_FIELDS:
        assert getattr(res.ledger, f) == getattr(sync.ledger, f)
    assert res.ledger.mean_awake() == N


def test_fdot_async_matches_reference(prob):
    x = prob["x"]
    slabs = [x[:4], x[4:8], x[8:11], x[11:]]
    g4 = jtopo.erdos_renyi(4, 0.9, seed=1)
    q_true = _top_r(x @ x.T, R)
    p_awake = np.array([0.5, 0.9, 0.9, 0.9])
    ref = jfdot(data_blocks=[jnp.asarray(s) for s in slabs],
                engine=jag.AsyncConsensus(g4, p_awake, seed=6), r=R,
                t_outer=6, t_c=10, q_init=jnp.asarray(prob["q_init"]),
                q_true=jnp.asarray(q_true))
    draws = _ref_awake_draws(6, p_awake, 4, 10, 3 * 6)
    kw = dict(data_blocks=[torch.tensor(s) for s in slabs], r=R, t_outer=6,
              t_c=10, q_init=torch.tensor(prob["q_init"]),
              q_true=torch.tensor(q_true), device="cpu", draws=draws)
    fused = fdot(engine=_engine(g4, p_awake, 6), **kw)
    eager = fdot(engine=_engine(g4, p_awake, 6), fused=False, **kw)
    np.testing.assert_allclose(fused.error_trace, np.asarray(ref.error_trace),
                               rtol=0, atol=TRACE_ATOL)
    np.testing.assert_allclose(fused.q_full.numpy(), np.asarray(ref.q_full),
                               rtol=0, atol=Q_ATOL)
    np.testing.assert_allclose(eager.q_full.numpy(), np.asarray(ref.q_full),
                               rtol=0, atol=Q_ATOL)
    for res in (fused, eager):
        for f in COUNT_FIELDS:
            assert getattr(res.ledger, f) == getattr(ref.ledger, f)
        assert res.ledger.awake_counts == ref.ledger.awake_counts


@pytest.mark.parametrize("kind", ["async", "faulty"])
def test_bdot_eager_accepts_async_and_faulty_engines(prob, kind):
    """B-DOT's eager loop gossips through each engine's run_debiased, as the
    reference's does; every node awake (or a fault-free model), the run is
    the reference's. The fused path still needs ``debias_table``."""
    from repro.core.netfaults import FaultyConsensus as JFaulty
    from repro.core.netfaults import NetFaultModel as JModel
    from repro_torch.core.netfaults import FaultyConsensus, NetFaultModel
    x = prob["x"][:, :120]
    grid = [[x[:8, :70], x[:8, 70:]], [x[8:, :70], x[8:, 70:]]]
    q_true = _top_r(x @ x.T, R)
    graphs = [jtopo.complete(2)] * 2

    def ref_eng(g):
        return (jag.AsyncConsensus(g, 1.0) if kind == "async"
                else JFaulty(g, JModel()))

    def port_eng(g):
        g = Graph(g.adjacency)
        return (AsyncConsensus(g, 1.0, device="cpu") if kind == "async"
                else FaultyConsensus(g, NetFaultModel(), device="cpu"))

    ref = jbdot(blocks=[[jnp.asarray(b) for b in row] for row in grid],
                col_engines=[ref_eng(g) for g in graphs],
                row_engines=[ref_eng(g) for g in graphs], r=R, t_outer=6,
                t_c=10, q_init=jnp.asarray(prob["q_init"]),
                q_true=jnp.asarray(q_true), fused=False)
    kw = dict(blocks=[[torch.tensor(b) for b in row] for row in grid], r=R,
              t_outer=6, t_c=10, q_init=torch.tensor(prob["q_init"]),
              q_true=torch.tensor(q_true), device="cpu")
    port = bdot(col_engines=[port_eng(g) for g in graphs],
                row_engines=[port_eng(g) for g in graphs], fused=False, **kw)
    np.testing.assert_allclose(port.error_trace, np.asarray(ref.error_trace),
                               rtol=0, atol=TRACE_ATOL)
    np.testing.assert_allclose(port.q_full.numpy(), np.asarray(ref.q_full),
                               rtol=0, atol=Q_ATOL)
    for f in COUNT_FIELDS:
        assert getattr(port.ledger, f) == getattr(ref.ledger, f)
    assert port.ledger.awake_counts == ref.ledger.awake_counts
    with pytest.raises(ValueError, match="debias_table"):
        bdot(col_engines=[port_eng(g) for g in graphs],
             row_engines=[port_eng(g) for g in graphs], **kw)


# ---------------------------------------------------------------------------
# chunked resume and the runtime's async half
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["sdot", "fdot"])
def test_async_chunked_resume_bitwise(tmp_path, prob, family):
    """Killed after one chunk and resumed on the same directory: the
    trace, iterate, ledger (with awake counts) and the engine's counter
    equal the uninterrupted run's bit for bit."""
    if family == "sdot":
        kw = dict(covs=torch.tensor(prob["covs"]), r=R, t_outer=9, t_c=12,
                  q_init=torch.tensor(prob["q_init"]),
                  q_true=torch.tensor(prob["q_true"]), device="cpu")
        chunked, q_attr, g = tresume.sdot_chunked, "q_nodes", prob["graph"]
        whole = sdot
    else:
        x = prob["x"]
        kw = dict(data_blocks=[torch.tensor(x[:7]), torch.tensor(x[7:])],
                  r=R, t_outer=9, t_c=12,
                  q_init=torch.tensor(prob["q_init"]),
                  q_true=torch.tensor(_top_r(x @ x.T, R)), device="cpu")
        chunked, q_attr, g = tresume.fdot_chunked, "q_full", jtopo.ring(2)
        whole = fdot
    e_mono = _engine(g, 0.7, 2)
    mono = whole(engine=e_mono, **kw)
    mgr = CheckpointManager(str(tmp_path))
    part = chunked(engine=_engine(g, 0.7, 2), chunk_size=4, manager=mgr,
                   max_chunks=1, **kw)
    assert len(part.error_trace) == 4
    e_res = _engine(g, 0.7, 2)
    res = chunked(engine=e_res, chunk_size=4, manager=mgr, **kw)
    np.testing.assert_array_equal(res.error_trace, mono.error_trace)
    assert torch.equal(getattr(res, q_attr), getattr(mono, q_attr))
    assert res.ledger == mono.ledger
    assert e_res._key.tolist() == e_mono._key.tolist()


def test_async_state_layout(prob):
    prog = sdot_program(covs=torch.tensor(prob["covs"]), r=R, t_outer=5,
                        t_c=9, engine=_engine(prob["graph"], 0.5, 8),
                        device="cpu")
    prog.finalize = None
    state = runtime.run_monolithic(prog)
    assert state.key.dtype == torch.int64 and state.key.tolist() == [8, 5]
    assert state.sends.shape == state.counts.shape == (5, 9)
    assert float(state.counts.max()) <= N and float(state.sends.sum()) > 0


def test_reference_async_checkpoint_refused(tmp_path, prob):
    """A checkpoint of the reference's async S-DOT holds a JAX key: the
    port refuses it with a clear error instead of reading it as its own."""
    g = prob["graph"]
    common = dict(covs=jnp.asarray(prob["covs"]), r=R, t_outer=8, t_c=10,
                  q_init=jnp.asarray(prob["q_init"]))
    jresume.sdot_chunked(engine=jag.AsyncConsensus(g, 0.7, seed=1),
                         chunk_size=4, manager=JManager(str(tmp_path)),
                         max_chunks=1, **common)
    prog = sdot_program(covs=torch.tensor(prob["covs"]), r=R, t_outer=8,
                        t_c=10, q_init=torch.tensor(prob["q_init"]),
                        engine=_engine(g, 0.7, 1), device="cpu")
    with pytest.raises(ValueError, match="JAX reference"):
        runtime.run_chunked(prog, CheckpointManager(str(tmp_path)),
                            chunk_size=4)


@pytest.mark.parametrize("t_round, delay, rs, ra", [
    (0.001, 0.01, 1000, 1000), (0.002, 0.05, 300, 420), (0.01, 0.0, 10, 0)])
def test_straggler_wall_clock_matches_reference(t_round, delay, rs, ra):
    kw = dict(n_nodes=10, t_round=t_round, delay=delay, rounds_sync=rs,
              rounds_async=ra)
    assert straggler_wall_clock(**kw) == jag.straggler_wall_clock(**kw)
    if ra == 1000:
        wc = straggler_wall_clock(**kw)
        assert wc["sync_s"] == pytest.approx(11.0)
        assert wc["speedup"] == pytest.approx(11.0)
