"""The port's streams, ingest sketches, metrics registry, chaos plans and
topology specs against the reference (CPU).

Twins of the ingestion half of ``tests/test_streaming.py`` and of the
registry half of ``tests/test_obs.py``, at test_streaming.py's sizes. The
port cannot replay ``jax.random``, so the sketches are fed the reference's
own batches (its stream's ``batch_fn``) and the Ritz track the reference's
init basis; populations and numpy-drawn chaos decisions are compared bit
for bit. Resumes are bitwise port against port.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.linalg import orthonormal_init as j_orthonormal_init
from repro.data import pipeline as jpipe
from repro.obs import Journal as JJournal
from repro.obs import registry as jreg
from repro.streaming import chaos as jchaos
from repro.streaming import ingest as jingest
from repro.streaming import launcher as jlauncher
from repro_torch import obs as tobs
from repro_torch._tree import tree_leaves as _leaves
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import pipeline as tpipe
from repro_torch.obs import registry as treg
from repro_torch.streaming import chaos as tchaos
from repro_torch.streaming import launcher as tlauncher
from repro_torch.streaming.ingest import FrequentDirections, StreamingIngestor

D, R, N, M = 14, 3, 6, 30
SKETCH_RTOL = 1e-5    # f32 second moments summed in another order
FD_RTOL = 1e-4        # B^T B through 12 batched SVDs, relative to its max
RITZ_ATOL = 1e-5      # Ritz values and basis from the same init basis
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


@pytest.fixture(scope="module")
def ref_stream():
    """The reference's eigengap stream, its batches as numpy arrays."""
    batch_fn, c, q = jpipe.eigengap_stream(D, R, 0.7, seed=0)
    cache = {}

    def np_batch(step, m):
        if (step, m) not in cache:
            cache[(step, m)] = np.asarray(batch_fn(step, m))
        return cache[(step, m)]

    return dict(jfn=batch_fn, fn=np_batch, c=c, q=q)


def _port_ingestor(fn, **kw):
    return StreamingIngestor(n_nodes=N, d=D, batch_fn=fn, batch_size=M,
                             device="cpu", **kw)


def _ref_ingestor(fn, **kw):
    return jingest.StreamingIngestor(n_nodes=N, d=D, batch_fn=fn,
                                     batch_size=M, **kw)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------
def test_stream_populations_are_the_references_bits():
    """C, Q_true and the factors come from the same numpy draws: equal bit
    for bit after the f32 cast, for the eigengap, drifting and spectrum
    streams."""
    _, c, q = tpipe.eigengap_stream(D, R, 0.7, seed=3, device="cpu")
    _, jc, jq = jpipe.eigengap_stream(D, R, 0.7, seed=3)
    assert np.array_equal(c.numpy(), np.asarray(jc))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    _, pre, post = tpipe.drifting_eigengap_stream(
        D, R, 0.6, 5, seed=1, shift_lead=6.0, device="cpu")
    _, jpre, jpost = jpipe.drifting_eigengap_stream(D, R, 0.6, 5, seed=1,
                                                    shift_lead=6.0)
    for got, want in zip(pre + post, jpre + jpost):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for seed in (0, 4):
        got = tpipe._spectrum_factor(np.random.default_rng(seed), D, 1.2)
        want = jpipe._spectrum_factor(np.random.default_rng(seed), D, 1.2)
        assert np.array_equal(got, want)
    assert np.array_equal(
        tpipe.spectrum_matched_data(D, 40, seed=2, device="cpu").numpy(),
        np.asarray(jpipe.spectrum_matched_data(D, 40, seed=2)))


def test_stream_is_stateless_and_drifts_at_its_shift():
    """A batch is a pure function of (seed, step): the same bits drawn
    twice, in any order, from two stream objects; steps differ; a drifting
    stream draws its pre-shift steps from the first population's stream
    and later ones from the shifted one."""
    fn, _, _ = tpipe.eigengap_stream(D, R, 0.7, seed=0, device="cpu")
    fn2, _, _ = tpipe.eigengap_stream(D, R, 0.7, seed=0, device="cpu")
    late = fn(7, M)
    assert torch.equal(fn(3, M), fn2(3, M))
    assert torch.equal(late, fn2(7, M))
    assert not torch.equal(fn(3, M), fn(4, M))
    drift, _, _ = tpipe.drifting_eigengap_stream(D, R, 0.7, 5, seed=0,
                                                 device="cpu")
    post, _, _ = tpipe.eigengap_stream(D, R, 0.7, seed=101, device="cpu")
    assert torch.equal(drift(4, M), fn(4, M))
    assert torch.equal(drift(5, M), post(5, M))
    sm = tpipe.spectrum_matched_stream(D, seed=2, device="cpu")
    assert torch.equal(sm(9, 8), sm(9, 8)) and sm(9, 8).shape == (D, 8)
    assert tpipe.stream_seed(0, 1) != tpipe.stream_seed(1, 0)


def test_synthetic_lm_stream_restarts_at_its_step():
    cfg = get_arch("qwen2-7b")
    it = tpipe.synthetic_lm_stream(cfg, 0, 2, 8, start_step=5, device="cpu")
    (s0, b0), (s1, b1) = next(it), next(it)
    assert (s0, s1) == (5, 6)
    want = tpipe.make_lm_batch(cfg, 0, 6, 2, 8, device="cpu")
    assert all(torch.equal(b1[k], want[k]) for k in want)
    assert torch.equal(b0["labels"][:, :-1], b0["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# sketches
# ---------------------------------------------------------------------------
def test_cov_sketch_matches_the_reference(ref_stream):
    """The same 20 batches into both exact sketches: within 1e-5 relative,
    and within 1e-5 of a float64 sum of the same per-node blocks."""
    port = _port_ingestor(ref_stream["fn"]).ingest(20)
    ref = _ref_ingestor(ref_stream["jfn"]).ingest(20)
    got, want = port.cov_stack().numpy(), np.asarray(ref.cov_stack())
    assert np.abs(got - want).max() <= SKETCH_RTOL * np.abs(want).max()
    blocks = [np.concatenate([ref_stream["fn"](t, M)[:, i * 5:(i + 1) * 5]
                              for t in range(20)], axis=1).astype(np.float64)
              for i in range(N)]
    exact = np.stack([b @ b.T / b.shape[1] for b in blocks])
    assert np.abs(got - exact).max() <= SKETCH_RTOL * np.abs(exact).max()
    assert np.array_equal(port.samples_per_node, np.full(N, 100.0))


@pytest.mark.parametrize("kw", [{}, {"track_top": R, "ritz_seed": 5},
                                {"sketch": "fd", "ell": 10}],
                         ids=["exact", "exact_ritz", "fd"])
def test_ingestor_resume_is_bitwise(tmp_path, kw):
    """Killed after 4 batches, checkpointed and restored into a fresh
    ingestor: 6 more batches give the uninterrupted run's bits (sketch,
    counts, the Ritz track)."""
    fn, _, _ = tpipe.eigengap_stream(D, R, 0.7, seed=0, device="cpu")
    full = _port_ingestor(fn, **kw).ingest(10)
    part = _port_ingestor(fn, **kw).ingest(4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(part.step, part.state())
    fresh = _port_ingestor(fn, **kw)
    tree, _ = mgr.restore(fresh.state())
    fresh.restore(tree).ingest(6)
    assert fresh.step == full.step == 10
    for a, b in zip(_leaves(fresh.state()), _leaves(full.state())):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kw", [{"track_top": R}, {"sketch": "fd", "ell": 10}],
                         ids=["exact_ritz", "fd"])
def test_state_layout_is_the_references(tmp_path, ref_stream, kw):
    """The reference's manager writes an ingestor state; the port's manager
    restores it into the port's state tree (same leaf names and shapes) and
    gets its values."""
    ref = _ref_ingestor(ref_stream["jfn"], **kw).ingest(3)
    JManager(str(tmp_path)).save(3, ref.state())
    port = _port_ingestor(ref_stream["fn"], **kw)
    tree, step = CheckpointManager(str(tmp_path)).restore(port.state())
    port.restore(tree)
    assert step == 3 and port.step == 3
    want = jax.tree_util.tree_leaves(ref.state())
    for a, b in zip(_leaves(port.state()), want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_ingest_rejections(ref_stream):
    with pytest.raises(ValueError, match="divide evenly"):
        StreamingIngestor(n_nodes=N, d=D, batch_fn=ref_stream["fn"],
                          batch_size=M + 1, device="cpu")
    with pytest.raises(ValueError, match="ingest"):
        _port_ingestor(ref_stream["fn"]).cov_stack()
    with pytest.raises(ValueError, match="ell"):
        FrequentDirections.init(2, 8, 9, device="cpu")
    with pytest.raises(ValueError, match="needs ell"):
        _port_ingestor(ref_stream["fn"], sketch="fd")
    with pytest.raises(ValueError, match="track_top"):
        _port_ingestor(ref_stream["fn"], track_top=D)
    untracked = _port_ingestor(ref_stream["fn"])
    assert set(untracked.state()) == {"step", "sketch"}
    with pytest.raises(ValueError, match="track_top"):
        untracked.eigengap
    with pytest.raises(ValueError, match="track_top"):
        untracked.top_basis()


def test_frequent_directions_matches_the_reference_and_its_bound(ref_stream):
    """ell = 10 over 12 batches: B^T B and the shrink loss within 1e-4 of
    the reference's; per node ||X X^T - B^T B||_2 <= shrink_loss against
    the port's exact sketch; the bound is not trivial."""
    port = _port_ingestor(ref_stream["fn"], sketch="fd", ell=10).ingest(12)
    ref = _ref_ingestor(ref_stream["jfn"], sketch="fd", ell=10).ingest(12)
    b = port.sketch.sketch
    bb = (b.mT @ b).numpy()
    jb = np.asarray(ref.sketch.sketch, np.float64)
    jbb = np.einsum("nld,nle->nde", jb, jb)
    assert np.abs(bb - jbb).max() <= FD_RTOL * np.abs(jbb).max()
    loss, jloss = port.sketch.shrink_loss.numpy(), np.asarray(
        ref.sketch.shrink_loss)
    assert np.abs(loss - jloss).max() <= FD_RTOL * np.abs(jloss).max()
    sm = _port_ingestor(ref_stream["fn"]).ingest(12).sketch.second_moment
    for i in range(N):
        gap = float(torch.linalg.matrix_norm(sm[i] - b[i].T @ b[i], ord=2))
        assert gap <= float(loss[i]) * (1 + 1e-4) + 1e-4
    assert (loss > 0).all()
    cov = port.cov_stack()
    assert torch.allclose(cov, (b.mT @ b) / 60.0)
    v = torch.eye(D)
    assert torch.allclose(port.sketch.apply_sum(v), (b.mT @ b).sum(0),
                          rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kw", [{}, {"sketch": "fd", "ell": 10}],
                         ids=["exact", "fd"])
def test_ritz_track_matches_the_reference(ref_stream, kw):
    """track_top = K from the reference's init basis: after 25 batches the
    Ritz values and basis within 1e-5 of the reference's, the gap too."""
    init = np.asarray(j_orthonormal_init(jax.random.PRNGKey(5), D, R + 1))
    port = _port_ingestor(ref_stream["fn"], track_top=R, ritz_init=init,
                          **kw).ingest(25)
    ref = _ref_ingestor(ref_stream["jfn"], track_top=R, ritz_seed=5,
                        **kw).ingest(25)
    assert np.abs(port.ritz_values - ref.ritz_values).max() <= RITZ_ATOL * max(
        1.0, float(np.abs(ref.ritz_values).max()))
    got, want = port._ritz_basis.numpy(), np.asarray(ref._ritz_basis)
    assert np.abs(got - want).max() <= RITZ_ATOL
    assert port.eigengap == pytest.approx(ref.eigengap, abs=RITZ_ATOL)
    assert port.top_basis().shape == (D, R)


# ---------------------------------------------------------------------------
# metrics registry and the journal's registry hook
# ---------------------------------------------------------------------------
def _observe(reg_mod):
    reg = reg_mod.MetricsRegistry()
    rng = np.random.default_rng(0)
    for v in rng.lognormal(-6.0, 1.5, 500):
        reg.histogram("lat_seconds").observe(float(v))
    reg.counter("req_total").inc()
    reg.counter("req_total").inc(4)
    reg.gauge("stale").set(3)
    reg.histogram("tiny", [0.1, 1.0]).observe(0.5)
    return reg


def test_registry_equals_the_references():
    """The same observations: equal snapshots, percentiles and exposition;
    a port dump loads into the reference's registry and the reverse; merge
    adds counters and histograms, the last gauge wins."""
    port, ref = _observe(treg), _observe(jreg)
    assert port.snapshot() == ref.snapshot()
    for p in (1, 50, 90, 99, 100):
        assert port.histogram("lat_seconds").percentile(p) == \
            ref.histogram("lat_seconds").percentile(p)
    assert port.to_prom() == ref.to_prom()
    assert port.histogram("lat_seconds").mean == \
        ref.histogram("lat_seconds").mean
    assert treg.MetricsRegistry().histogram("x").p50 is None


def test_registry_dumps_cross_load(tmp_path):
    port = _observe(treg)
    path = port.dump(str(tmp_path / "port.json"))
    assert jreg.MetricsRegistry.load(path).snapshot() == port.snapshot()
    jpath = _observe(jreg).dump(str(tmp_path / "ref.json"))
    merged = treg.MetricsRegistry.load(jpath).merge_snapshot(
        port.snapshot())
    assert merged.counter("req_total").value == 10
    assert merged.histogram("lat_seconds").count == 1000
    assert merged.gauge("stale").value == 3
    with pytest.raises(ValueError, match="bounds"):
        merged.histogram("tiny").merge(
            treg.Histogram([0.5]).snapshot())
    with pytest.raises(TypeError):
        merged.gauge("req_total")


def test_journal_feeds_span_durations_to_a_registry(tmp_path, monkeypatch):
    """install(): an attempt-scoped journal under <workdir>/obs whose closed
    spans observe ``span_<name>_seconds``; REPRO_OBS=0 gives a no-op
    journal and REPRO_OBS_DIR moves the directory (the reference's rule)."""
    monkeypatch.delenv(tobs.ENV_OBS, raising=False)
    monkeypatch.delenv(tobs.ENV_DIR, raising=False)
    try:
        j = tobs.install(str(tmp_path), "svc")
        with j.span("ingest", "serving") as sp:
            sp.add(batch=1)
        j.begin("gate").end(ok=False)
        reg = tobs.metrics()
        assert reg.histogram("span_ingest_seconds").count == 1
        assert reg.histogram("span_gate_seconds").count == 1
        assert os.path.basename(j.path) == "svc.a0.jsonl"
        assert tobs.obs_dir_for(str(tmp_path)) == str(tmp_path / "obs")
        recs = tobs.read_journal(j.path)
        assert recs[1]["batch"] == 1 and recs[-1]["ok"] is False
        assert tobs.install(str(tmp_path), "svc").attempt == 1
        monkeypatch.setenv(tobs.ENV_DIR, str(tmp_path / "elsewhere"))
        assert tobs.obs_dir_for("x") == str(tmp_path / "elsewhere")
        monkeypatch.setenv(tobs.ENV_OBS, "0")
        assert tobs.obs_dir_for("x") is None
        assert not tobs.install(str(tmp_path), "svc").enabled
        assert tobs.Journal.noop().begin("x").add(a=1) is not None
        assert JJournal.noop().begin("x").add(a=1) is not None
    finally:
        tobs.set_journal(tobs.Journal.noop())


# ---------------------------------------------------------------------------
# chaos plans and topology specs
# ---------------------------------------------------------------------------
_SERVING_PLAN = {"seed": 3, "faults": [
    {"kind": "kill", "worker": "service", "boundary": 7},
    {"kind": "kill", "worker": "resolve"},
    {"kind": "hang", "worker": "service", "sleep": 60},
    {"kind": "delay_query", "p": 0.4, "delay": 0.5},
    {"kind": "delay_query", "p": 0.7, "delay": 0.01},
    {"kind": "corrupt_candidate", "mode": "scale", "resolve": 1}]}


def test_fault_plans_round_trip_with_the_references(tmp_path):
    """examples/chaos_plan.json and a serving plan load in both packages;
    each package's dump loads in the other with the same faults and seed;
    boundaries agree for every fault."""
    with open(tmp_path / "serving.json", "w") as f:
        json.dump(_SERVING_PLAN, f)
    for path in (os.path.join(EXAMPLES, "chaos_plan.json"),
                 str(tmp_path / "serving.json")):
        port, ref = tchaos.FaultPlan.load(path), jchaos.FaultPlan.load(path)
        back = jchaos.FaultPlan.load(port.dump(str(tmp_path / "p.json")))
        fwd = tchaos.FaultPlan.load(ref.dump(str(tmp_path / "r.json")))
        for plan in (back, fwd):
            assert (plan.seed, plan.faults) == (ref.seed, ref.faults)
        for i in range(len(ref.faults)):
            for n in (1, 5, 26, 100):
                assert port.boundary_for(i, n) == ref.boundary_for(i, n)
    for bad in ({"kind": "explode"}, {"kind": "delay_query", "p": 1.5},
                {"kind": "delay_query", "delay": -1},
                {"kind": "corrupt_candidate", "mode": "zero"}):
        with pytest.raises(ValueError) as want:
            jchaos.FaultPlan([bad])
        with pytest.raises(ValueError) as got:
            tchaos.FaultPlan([bad])
        assert str(got.value) == str(want.value)


def test_chaos_hooks_draw_the_references_delays(tmp_path):
    """query_delay for 300 request ids, and the mangled candidate, equal
    the reference's for the same plan; one-shot markers stop a second
    firing; an inert hook changes nothing."""
    plan = tchaos.FaultPlan(_SERVING_PLAN["faults"], seed=3)
    jplan = jchaos.FaultPlan(_SERVING_PLAN["faults"], seed=3)
    port = tchaos.ChaosHooks(plan, state_dir=str(tmp_path / "t"))
    ref = jchaos.ChaosHooks(jplan, state_dir=str(tmp_path / "j"))
    assert [port.query_delay(i) for i in range(300)] == \
        [ref.query_delay(i) for i in range(300)]
    q = np.eye(D, R, dtype=np.float32)
    assert port.mangle_candidate(q, 0) is q
    got = port.mangle_candidate(q, 1)
    assert np.array_equal(got, np.asarray(ref.mangle_candidate(q, 1)))
    assert port.mangle_candidate(q, 1) is q             # fired once
    inert = tchaos.ChaosHooks(None)
    assert inert.query_delay(3) == 0.0 and not inert.active
    inert.at_boundary(7)
    nan = tchaos.ChaosHooks(tchaos.FaultPlan(
        [{"kind": "corrupt_candidate"}]), state_dir=str(tmp_path / "n"))
    assert np.isnan(nan.mangle_candidate(q, 4)).sum() == 1
    slow = tchaos.ChaosHooks(tchaos.FaultPlan(
        [{"kind": "slow", "worker": "service", "sleep": 0.0}]),
        worker="service", step_boundaries=True)
    slow.at_boundary(3)
    assert slow._boundary == 3


def test_topology_specs_build_the_references_engines():
    specs = [{"kind": "er", "n": 8, "p": 0.4, "seed": 2},
             {"kind": "ring", "n": 6}, {"kind": "star", "n": 5},
             {"kind": "complete", "n": 4},
             {"kind": "torus2d", "rows": 3, "cols": 4}]
    for spec in specs:
        got = tlauncher.build_engine(spec, device="cpu")
        want = jlauncher.build_engine(spec)
        assert np.array_equal(got.weights, np.asarray(want.weights))
    with pytest.raises(ValueError, match="unknown topology"):
        tlauncher.build_engine({"kind": "hypercube"}, device="cpu")
    for sched in (None, {"values": [3, 4, 5, 6]}, {"kind": "lin2", "cap": 9}):
        assert np.array_equal(tlauncher.build_schedule(sched, 4, 7),
                              jlauncher.build_schedule(sched, 4, 7))
