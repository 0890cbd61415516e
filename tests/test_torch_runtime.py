"""The port's runtime: the Program protocol, its drivers and checkpointed
kill-and-resume of S-DOT, F-DOT and B-DOT (CPU).

Twins of ``tests/test_runtime.py`` and of the sync halves of
``tests/test_streaming.py``. Each resume is bitwise port against port (a
killed and resumed run against the uninterrupted one), and each run is held
against the reference's ``*_chunked`` on the same NumPy inputs at the
S-DOT/F-DOT/B-DOT parity tolerances of tests/test_torch_{sdot,fdot}.py.
The last tests finish, in the port, runs the reference checkpointed.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import consensus as jc
from repro.core import topology as jtopo
from repro.streaming import resume as jresume
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import runtime
from repro_torch.core.bdot import bdot, bdot_program
from repro_torch.core.fdot import fdot, fdot_program
from repro_torch.core.metrics import subspace_error
from repro_torch.core.sdot import sdot, sdot_program
from repro_torch.interop import from_reference_arrays
from repro_torch.obs import Journal, read_journal, set_journal
from repro_torch.streaming import resume as tresume

D, R, N = 14, 3, 6
T_OUTER, T_C, CHUNK = 12, 15, 5
TRACE_ATOL = 1e-5     # f32 on both sides; gossip and QR sum in another order
SPAN_TOL = 1e-5       # per-node subspace error between two S-DOT iterates
Q_ATOL = 1e-5         # F-DOT/B-DOT q_full element by element
LEDGER_FIELDS = ("p2p", "matrices", "scalars", "payload_bytes")


def _top_r(m, r):
    return np.linalg.eigh(m)[1][:, ::-1][:, :r].astype(np.float32).copy()


@pytest.fixture(scope="module")
def sprob():
    """S-DOT: N nodes of 60 samples each, an ER(N, 0.5) graph."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((D, 60 * N)).astype(np.float32)
    covs = np.stack([x[:, 60 * i:60 * (i + 1)] @ x[:, 60 * i:60 * (i + 1)].T
                     / 60 for i in range(N)]).astype(np.float32)
    arrays = dict(adjacency=jtopo.erdos_renyi(N, 0.5, seed=1).adjacency,
                  covs=covs, q_true=_top_r(covs.sum(0), R),
                  q_init=np.linalg.qr(rng.standard_normal((D, R)))[0]
                  .astype(np.float32))
    st = from_reference_arrays(arrays, device="cpu")
    port = dict(covs=st["covs"], engine=st["engine"], r=R, t_outer=T_OUTER,
                t_c=T_C, q_init=st["q_init"], q_true=st["q_true"],
                device="cpu")
    ref = dict(covs=jnp.asarray(covs), r=R, t_outer=T_OUTER, t_c=T_C,
               q_init=jnp.asarray(arrays["q_init"]),
               q_true=jnp.asarray(arrays["q_true"]))
    return dict(port=port, ref=ref,
                ref_engine=lambda: jc.DenseConsensus(
                    jtopo.Graph(arrays["adjacency"])))


@pytest.fixture(scope="module")
def fprob():
    """F-DOT: 16 features over 4 slabs, an ER(4, 0.9) graph."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 240)).astype(np.float32)
    slabs = [x[4 * i:4 * (i + 1)] for i in range(4)]
    arrays = dict(adjacency=jtopo.erdos_renyi(4, 0.9, seed=1).adjacency,
                  slabs=slabs, q_true=_top_r(x @ x.T / 240, R),
                  q_init=np.linalg.qr(rng.standard_normal((16, R)))[0]
                  .astype(np.float32))
    st = from_reference_arrays(arrays, device="cpu")
    port = dict(data_blocks=st["data_blocks"], engine=st["engine"], r=R,
                t_outer=9, t_c=T_C, q_init=st["q_init"], q_true=st["q_true"],
                device="cpu")
    ref = dict(data_blocks=[jnp.asarray(s) for s in slabs], r=R, t_outer=9,
               t_c=T_C, q_init=jnp.asarray(arrays["q_init"]),
               q_true=jnp.asarray(arrays["q_true"]))
    return dict(port=port, ref=ref, chunk=4,
                ref_engine=lambda: jc.DenseConsensus(
                    jtopo.Graph(arrays["adjacency"])))


@pytest.fixture(scope="module")
def gprob():
    """B-DOT: a 2 x 3 grid over a ragged feature/sample partition."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((12, 120)).astype(np.float32)
    d_rows, n_cols = [7, 5], [50, 40, 30]
    rows = np.cumsum([0] + d_rows)
    cols = np.cumsum([0] + n_cols)
    grid = [[x[rows[i]:rows[i + 1], cols[j]:cols[j + 1]] for j in range(3)]
            for i in range(2)]
    arrays = dict(grid=grid, col_adjacency=[jtopo.complete(2).adjacency] * 3,
                  row_adjacency=[jtopo.ring(3).adjacency] * 2,
                  q_true=_top_r(x @ x.T / 120, R),
                  q_init=np.linalg.qr(rng.standard_normal((12, R)))[0]
                  .astype(np.float32))
    st = from_reference_arrays(arrays, device="cpu")
    port = dict(blocks=st["blocks"], col_engines=st["col_engines"],
                row_engines=st["row_engines"], r=R, t_outer=9, t_c=10,
                q_init=st["q_init"], q_true=st["q_true"], device="cpu")
    ref = dict(blocks=[[jnp.asarray(b) for b in row] for row in grid],
               r=R, t_outer=9, t_c=10, q_init=jnp.asarray(arrays["q_init"]),
               q_true=jnp.asarray(arrays["q_true"]))
    return dict(port=port, ref=ref, chunk=4,
                ref_engines=lambda: dict(
                    col_engines=[jc.DenseConsensus(jtopo.complete(2))
                                 for _ in range(3)],
                    row_engines=[jc.DenseConsensus(jtopo.ring(3))
                                 for _ in range(2)]))


def _assert_same_run(a, b, q_attr):
    """Bitwise: trace, iterate and ledger."""
    np.testing.assert_array_equal(a.error_trace, b.error_trace)
    assert torch.equal(getattr(a, q_attr), getattr(b, q_attr))
    for f in LEDGER_FIELDS:
        assert getattr(a.ledger, f) == getattr(b.ledger, f)
    assert a.ledger.awake_counts == b.ledger.awake_counts


def _assert_parity(port, ref, q_attr):
    """The port's run against the reference's at the parity tolerances."""
    np.testing.assert_allclose(port.error_trace, np.asarray(ref.error_trace),
                               rtol=0, atol=TRACE_ATOL)
    q_ref = torch.tensor(np.asarray(getattr(ref, q_attr)))
    if q_attr == "q_nodes":
        per_node = subspace_error(q_ref, port.q_nodes)
        assert float(per_node.max()) <= SPAN_TOL
    else:
        np.testing.assert_allclose(getattr(port, q_attr).numpy(),
                                   q_ref.numpy(), rtol=0, atol=Q_ATOL)
    for f in LEDGER_FIELDS:
        assert getattr(port.ledger, f) == getattr(ref.ledger, f)


# ---------------------------------------------------------------------------
# the Program protocol
# ---------------------------------------------------------------------------
def test_program_basics(sprob):
    prog = sdot_program(**sprob["port"])
    assert prog.t_outer == T_OUTER
    res = runtime.run_monolithic(prog)
    assert prog.restored_step == 0
    np.testing.assert_array_equal(res.error_trace,
                                  sdot(**sprob["port"]).error_trace)


def test_body_steps_carry_and_state_keeps_zero_async_leaves(sprob):
    """A body is one outer step in the unified signature
    ``((carry, key), t_c) -> ((carry', key'), (cross, sends, counts))``; a
    sync body passes the key through and has no sends or counts, and a
    sync run's key, sends and counts stay the reference's zeros."""
    prog = sdot_program(**sprob["port"])
    body = prog.build_body(prog.operands, **dict(prog.statics))
    key = torch.zeros((), dtype=torch.uint32)
    (carry, key_out), (cross, sends, counts) = body((prog.q0, key),
                                                    int(prog.xs[0]))
    assert carry.shape == prog.q0.shape and cross.shape == (N, R, R)
    assert key_out is key and sends is None and counts is None
    prog.finalize = None
    state = runtime.run_monolithic(prog)
    assert int(state.step) == T_OUTER
    assert state.key.shape == () and state.key.dtype == torch.uint32
    assert int(state.key) == 0
    for leaf in (state.sends, state.counts):
        assert leaf.shape == (T_OUTER,) and leaf.dtype == torch.float32
        assert not leaf.any()


def test_sweeps_async_ledger_and_baselines_raise(sprob):
    """``run_sweep`` refuses a Program without case and seed axes, as the
    reference does; ``baseline_chunked`` runs a fused baseline (it raised
    before the baselines were ported); the realized async ledger equals
    the reference's on the same buffers (F-DOT's layout: three gossip
    calls a step)."""
    from repro.core import runtime as jruntime
    with pytest.raises(ValueError, match="case and seed axes"):
        runtime.run_sweep(sdot_program(**sprob["port"]))
    res = tresume.baseline_chunked(
        "dsa", covs=sprob["port"]["covs"], engine=sprob["port"]["engine"],
        r=R, t_outer=4, q_true=sprob["port"]["q_true"], device="cpu")
    assert res.error_trace.shape == (4,) and res.q.shape == (N, D, R)
    rng = np.random.default_rng(4)
    sched = np.array([6, 4, 6, 5])
    sends = rng.integers(0, 30, size=(4, 3, 6)).astype(np.float32)
    counts = rng.integers(0, N + 1, size=(4, 3, 6)).astype(np.float32)
    args = (lambda s: float(s[:, 0].sum()) * 50 + float(s[:, 1:].sum()) * 9,
            lambda t_c: [((0,), t_c)] + [((1 + k,), 6) for k in range(2)])
    got = runtime.async_ledger(sched, torch.tensor(sends),
                               torch.tensor(counts), *args)
    want = jruntime.async_ledger(sched, jnp.asarray(sends),
                                 jnp.asarray(counts), *args)
    for f in LEDGER_FIELDS:
        assert getattr(got, f) == getattr(want, f)
    assert got.awake_counts == want.awake_counts
    assert got.mean_awake() == want.mean_awake()


def test_bdot_chunk_size_invariance(gprob):
    mono = bdot(**gprob["port"])
    ref = jresume.bdot_chunked(chunk_size=4, **gprob["ref_engines"](),
                               **gprob["ref"])
    _assert_parity(mono, ref, "q_full")
    for chunk in (1, 4, 9 + 5):
        res = tresume.bdot_chunked(chunk_size=chunk, **gprob["port"])
        _assert_same_run(res, mono, "q_full")


def test_bdot_program_rejects_eager_only_engines(gprob):
    class Bare:
        pass

    kw = dict(gprob["port"], col_engines=[Bare()] * 3)
    with pytest.raises(ValueError, match="debias_table"):
        bdot_program(**kw)


# ---------------------------------------------------------------------------
# kill at a chunk boundary, resume from the checkpoint: the same bits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kill_at", [1, 2])
def test_sdot_sync_crash_resume_bitwise(tmp_path, sprob, kill_at):
    kw = sprob["port"]
    mono = sdot(**kw)
    mgr = CheckpointManager(str(tmp_path / f"k{kill_at}"))
    part = tresume.sdot_chunked(chunk_size=CHUNK, manager=mgr,
                                max_chunks=kill_at, **kw)
    assert len(part.error_trace) == min(kill_at * CHUNK, T_OUTER)
    res = tresume.sdot_chunked(chunk_size=CHUNK, manager=mgr, **kw)
    _assert_same_run(res, mono, "q_nodes")
    ref = jresume.sdot_chunked(engine=sprob["ref_engine"](), chunk_size=CHUNK,
                               **sprob["ref"])
    _assert_parity(res, ref, "q_nodes")


@pytest.mark.parametrize("kill_at", [1, 2])
def test_fdot_crash_resume_bitwise(tmp_path, fprob, kill_at):
    kw, chunk = fprob["port"], fprob["chunk"]
    mono = fdot(**kw)
    mgr = CheckpointManager(str(tmp_path))
    tresume.fdot_chunked(chunk_size=chunk, manager=mgr, max_chunks=kill_at,
                         **kw)
    res = tresume.fdot_chunked(chunk_size=chunk, manager=mgr, **kw)
    _assert_same_run(res, mono, "q_full")
    ref = jresume.fdot_chunked(engine=fprob["ref_engine"](), chunk_size=chunk,
                               **fprob["ref"])
    _assert_parity(res, ref, "q_full")


@pytest.mark.parametrize("kill_at", [1, 2])
def test_bdot_crash_resume_bitwise(tmp_path, gprob, kill_at):
    kw = gprob["port"]
    mono = bdot(**kw)
    mgr = CheckpointManager(str(tmp_path / f"k{kill_at}"))
    part = tresume.bdot_chunked(chunk_size=4, manager=mgr,
                                max_chunks=kill_at, **kw)
    assert len(part.error_trace) == min(kill_at * 4, 9)
    res = tresume.bdot_chunked(chunk_size=4, manager=mgr, **kw)
    _assert_same_run(res, mono, "q_full")
    ref = jresume.bdot_chunked(chunk_size=4, **gprob["ref_engines"](),
                               **gprob["ref"])
    _assert_parity(res, ref, "q_full")


def test_target_step_stops_at_an_absolute_step(tmp_path, sprob):
    """``target_step`` advances to an absolute step, and a repeated call
    with the same target runs nothing: a re-run increment never advances
    the run twice."""
    kw = sprob["port"]
    mgr = CheckpointManager(str(tmp_path))
    for _ in range(2):
        part = runtime.run_chunked(sdot_program(**kw), mgr, chunk_size=CHUNK,
                                   target_step=7)
        assert len(part.error_trace) == 7 and mgr.latest_step() == 7
    prog = sdot_program(**kw)
    res = runtime.run_chunked(prog, mgr, chunk_size=CHUNK)
    assert prog.restored_step == 7
    _assert_same_run(res, sdot(**kw), "q_nodes")


def _corrupt(root, step):
    with open(os.path.join(root, f"step_{step:08d}", "shards.npz"),
              "wb") as f:
        f.write(b"not an npz")


def test_corrupt_latest_checkpoint_recovery(tmp_path, sprob):
    """A torn newest snapshot (manifest present, shards unreadable) falls
    back to the newest restorable step; the trace is still bitwise."""
    kw = sprob["port"]
    mono = sdot(**kw)
    mgr = CheckpointManager(str(tmp_path), keep_last=5)
    tresume.sdot_chunked(chunk_size=CHUNK, manager=mgr, max_chunks=2, **kw)
    steps = mgr.all_steps()
    assert len(steps) == 2
    _corrupt(tmp_path, steps[-1])
    prog = sdot_program(**kw)
    res = runtime.run_chunked(prog, mgr, chunk_size=CHUNK)
    assert prog.restored_step == steps[0]
    _assert_same_run(res, mono, "q_nodes")


def test_bdot_corrupt_latest_checkpoint_recovery(tmp_path, gprob):
    kw = gprob["port"]
    mono = bdot(**kw)
    mgr = CheckpointManager(str(tmp_path), keep_last=5)
    tresume.bdot_chunked(chunk_size=4, manager=mgr, max_chunks=2, **kw)
    steps = mgr.all_steps()
    assert len(steps) == 2
    _corrupt(tmp_path, steps[-1])
    res = tresume.bdot_chunked(chunk_size=4, manager=mgr, **kw)
    _assert_same_run(res, mono, "q_full")


def test_all_checkpoints_corrupt_falls_back_to_fresh(tmp_path, sprob):
    kw = sprob["port"]
    mono = sdot(**kw)
    mgr = CheckpointManager(str(tmp_path))
    tresume.sdot_chunked(chunk_size=CHUNK, manager=mgr, max_chunks=1, **kw)
    for s in mgr.all_steps():
        _corrupt(tmp_path, s)
    prog = sdot_program(**kw)
    with pytest.warns(UserWarning, match="none restored"):
        res = runtime.run_chunked(prog, mgr, chunk_size=CHUNK)
    assert prog.restored_step == 0
    _assert_same_run(res, mono, "q_nodes")


def test_stale_checkpoint_dir_rejected_with_warning(tmp_path, sprob):
    """A directory from a run with another t_outer holds buffers of the
    wrong length: the run warns, starts fresh, and gives the full trace."""
    kw = sprob["port"]
    mgr = CheckpointManager(str(tmp_path))
    tresume.sdot_chunked(chunk_size=CHUNK, manager=mgr, max_chunks=1, **kw)
    longer = dict(kw, t_outer=T_OUTER + 8)
    mono = sdot(**longer)
    with pytest.warns(UserWarning, match="none restored"):
        res = tresume.sdot_chunked(chunk_size=CHUNK, manager=mgr, **longer)
    _assert_same_run(res, mono, "q_nodes")


@pytest.mark.parametrize("chunk", [1, 4, T_OUTER, T_OUTER + 7])
def test_chunk_size_invariance(sprob, chunk):
    """The trace must not depend on where the chunk boundaries fall."""
    mono = sdot(**sprob["port"])
    res = tresume.sdot_chunked(chunk_size=chunk, **sprob["port"])
    _assert_same_run(res, mono, "q_nodes")


def test_journal_records_chunks_and_saves_without_changing_bits(tmp_path,
                                                                sprob):
    """Tracing is out of band: a traced chunked run writes its chunk and
    checkpoint records and gives the untraced run's bits."""
    kw = sprob["port"]
    plain = tresume.sdot_chunked(chunk_size=CHUNK, **kw)
    journal = set_journal(Journal.open(str(tmp_path / "obs"), "run"))
    try:
        traced = tresume.sdot_chunked(
            chunk_size=CHUNK, manager=CheckpointManager(str(tmp_path / "c")),
            **kw)
    finally:
        journal.close()
        set_journal(Journal.noop())
    _assert_same_run(traced, plain, "q_nodes")
    recs = read_journal(journal.path)
    chunks = [r for r in recs if r["name"] == "chunk"]
    assert [r["step"] for r in chunks] == [5, 10, 12]
    assert all(r["phase"] == "runtime" for r in chunks)
    assert sum(r["name"] == "chunks_done" for r in recs) == 1
    saves = [r for r in recs if r["name"] == "ckpt_save"]
    assert [r["kind"] for r in saves] == ["span_start", "span"] * 3
    assert sum(r["name"] == "ckpt_write" for r in recs) == 3


# ---------------------------------------------------------------------------
# the reference's checkpoint, finished by the port
# ---------------------------------------------------------------------------
def test_port_finishes_a_killed_reference_sdot_run(tmp_path, sprob):
    """The reference's sdot_chunked is killed after 2 chunks; the port
    restores its step from the same directory and finishes the run, which
    then matches the reference's uninterrupted run."""
    ref_full = jresume.sdot_chunked(engine=sprob["ref_engine"](),
                                    chunk_size=CHUNK, **sprob["ref"])
    jresume.sdot_chunked(engine=sprob["ref_engine"](), chunk_size=CHUNK,
                         manager=JManager(str(tmp_path)), max_chunks=2,
                         **sprob["ref"])
    prog = sdot_program(**sprob["port"])
    res = runtime.run_chunked(prog, CheckpointManager(str(tmp_path)),
                              chunk_size=CHUNK)
    assert prog.restored_step == 2 * CHUNK
    _assert_parity(res, ref_full, "q_nodes")


@pytest.mark.parametrize("family", ["fdot", "bdot"])
def test_port_finishes_a_killed_reference_fdot_bdot_run(tmp_path, fprob,
                                                        gprob, family):
    prob = fprob if family == "fdot" else gprob
    chunk = prob["chunk"]
    if family == "fdot":
        run_ref = lambda **kw: jresume.fdot_chunked(  # noqa: E731
            engine=prob["ref_engine"](), chunk_size=chunk, **prob["ref"],
            **kw)
        program = fdot_program
    else:
        run_ref = lambda **kw: jresume.bdot_chunked(  # noqa: E731
            chunk_size=chunk, **prob["ref_engines"](), **prob["ref"], **kw)
        program = bdot_program
    ref_full = run_ref()
    run_ref(manager=JManager(str(tmp_path)), max_chunks=1)
    prog = program(**prob["port"])
    res = runtime.run_chunked(prog, CheckpointManager(str(tmp_path)),
                              chunk_size=chunk)
    assert prog.restored_step == chunk
    _assert_parity(res, ref_full, "q_full")


def test_port_finishes_a_sweep_the_reference_checkpointed_mid_grid(
        tmp_path, sprob):
    """The reference's sync sdot_sweep (two cases x two seeds) is killed
    after 2 chunks; the port restores its sweep-RunState, lane axes and
    all, from the same directory and finishes the grid, which then matches
    the reference's uninterrupted sweep within TRACE_ATOL. A reference
    netfault_sweep checkpoint is refused: its (C, S, 2) keys are JAX keys
    (uint32), not the port's int64 [seed, counter]."""
    from repro.core import sweep as jsweep
    from repro.core import netfaults as jnet
    from repro_torch.core import sweep as tsweep
    from repro_torch.core.consensus import consensus_schedule
    from repro_torch.core.netfaults import FaultyConsensus, NetFaultModel

    seeds = [0, 1]
    sched = [consensus_schedule("const", T_OUTER, t_max=T_C),
             consensus_schedule("lin2", T_OUTER, cap=T_C)]
    q_inits = np.asarray(jsweep._seed_inits(seeds, D, R))
    kw = dict(r=R, t_outer=T_OUTER, schedules=sched, seeds=seeds)
    ref_kw = dict(covs=sprob["ref"]["covs"], q_true=sprob["ref"]["q_true"],
                  **kw)
    ref_full = jsweep.sdot_sweep(engines=sprob["ref_engine"](), **ref_kw)
    jsweep.sdot_sweep(engines=sprob["ref_engine"](), chunk_size=CHUNK,
                      manager=JManager(str(tmp_path / "sync")), max_chunks=2,
                      **ref_kw)
    port_kw = dict(covs=sprob["port"]["covs"],
                   q_true=sprob["port"]["q_true"],
                   q_inits=torch.tensor(q_inits), **kw)
    res = tsweep.sdot_sweep(engines=sprob["port"]["engine"],
                            manager=CheckpointManager(str(tmp_path / "sync")),
                            chunk_size=CHUNK, **port_kw)
    assert res.resumed_step == 2 * CHUNK
    np.testing.assert_allclose(res.error_traces, ref_full.error_traces,
                               rtol=0, atol=TRACE_ATOL)
    for f in LEDGER_FIELDS:
        assert getattr(res.ledger, f) == getattr(ref_full.ledger, f)

    model = dict(p_drop=0.1, p_bad=0.05, p_good=0.5)
    jsweep.netfault_sweep(
        covs=sprob["ref"]["covs"], r=R, t_outer=4, t_c=5, seeds=seeds,
        engines=[jnet.FaultyConsensus(jtopo.Graph(
            sprob["port"]["engine"].graph.adjacency),
            jnet.NetFaultModel(**model), seed=3)],
        manager=JManager(str(tmp_path / "faulty")), chunk_size=2,
        max_chunks=1)
    with pytest.raises(ValueError, match="JAX reference"):
        tsweep.netfault_sweep(
            covs=sprob["port"]["covs"], r=R, t_outer=4, t_c=5, seeds=seeds,
            engines=[FaultyConsensus(sprob["port"]["engine"].graph,
                                     NetFaultModel(**model), seed=3,
                                     device="cpu")],
            manager=CheckpointManager(str(tmp_path / "faulty")),
            chunk_size=2)
