"""The port's serving layer against the reference (CPU).

Twins of ``tests/test_serving.py`` at its sizes (D = 12, R = 3, N = 4).
The port cannot replay ``jax.random``, so every draw the reference makes
enters the port through ``ServiceDraws`` (the stream's batches, the first
served Q, the Ritz init, each cold re-solve's Q_init) or a ``q_init``; the
gate's held-out batch and the queries are numpy draws in both packages.
Resumes, supervised relaunches and the gate are port against port, bit for
bit. The reference's own warm-start assertion fails (ROADMAP, reference
caveats), so the warm and cold counts are held to the reference's counts,
not to an order.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as jcons
from repro.core import linalg as jlinalg
from repro.core import runtime as jruntime
from repro.core import sdot as jsdot
from repro.core import topology as jtopo
from repro.data import pipeline as jpipe
from repro.serving import drift as jdrift
from repro.serving import query as jquery
from repro.serving import service as jservice
from repro.streaming import ingest as jingest
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.consensus import DenseConsensus
from repro_torch.core.runtime import run_chunked, run_monolithic
from repro_torch.core.sdot import sdot_program
from repro_torch.core.topology import erdos_renyi
from repro_torch.serving import service as tservice
from repro_torch.serving.drift import DriftDetector
from repro_torch.serving.query import QueryPath
from repro_torch.serving.service import (PSAService, ServiceConfig,
                                         ServiceDraws, service_summary)
from repro_torch.streaming.chaos import FaultPlan
from repro_torch.streaming.ingest import StreamingIngestor

D, R, N = 12, 3, 4
T_OUTER, T_C, CHUNK = 12, 12, 3
TRACE_ATOL = 1e-5     # f32 S-DOT traces from the same init
Q_ATOL = 1e-5         # a served subspace element by element
CPU = "cpu"


def _j_init(seed, d=D, r=R):
    return np.asarray(jlinalg.orthonormal_init(jax.random.PRNGKey(seed), d,
                                               r))


def _np_fn(jfn):
    return lambda step, m: np.asarray(jfn(step, m))


@pytest.fixture(scope="module")
def shifted_problem():
    """tests/test_serving.py's drifting stream ingested just past its shift,
    by the reference: pre-shift and early post-shift covs."""
    batch_fn, _, _ = jpipe.drifting_eigengap_stream(
        D, R, 0.6, shift_at=6, seed=0, lead=3.0, shift_lead=6.0)
    ing = jingest.StreamingIngestor(n_nodes=N, d=D, batch_fn=batch_fn,
                                    batch_size=32)
    ing.ingest(6)
    covs_pre = np.asarray(ing.cov_stack())
    ing.ingest(2)
    covs_post = np.asarray(ing.cov_stack())
    return dict(covs_pre=covs_pre, covs_post=covs_post, jfn=batch_fn,
                engine=DenseConsensus(erdos_renyi(N, 0.6, seed=1),
                                      device=CPU),
                jengine=jcons.DenseConsensus(jtopo.erdos_renyi(N, 0.6,
                                                               seed=1)))


def _prog(covs, engine, q_init, q_true=None, t_outer=T_OUTER):
    return sdot_program(covs=torch.as_tensor(covs), engine=engine, r=R,
                        t_outer=t_outer, t_c=T_C,
                        q_init=torch.as_tensor(np.asarray(q_init)),
                        q_true=q_true, device=CPU)


def _jprog(covs, engine, q_init, q_true=None, t_outer=T_OUTER):
    return jsdot.sdot_program(covs=jnp.asarray(covs), engine=engine, r=R,
                              t_outer=t_outer, t_c=T_C,
                              q_init=jnp.asarray(q_init), q_true=q_true)


def _iterations(trace, target=1e-3):
    return int(np.argmax(np.asarray(trace) < target)) + 1


# ---------------------------------------------------------------------------
# warm vs cold, re-solve resume, absolute targets
# ---------------------------------------------------------------------------
def test_warm_and_cold_counts_equal_the_references(shifted_problem):
    """From the reference's inits (PRNGKey 3 for the incumbent on the
    pre-shift covs, PRNGKey 4 for the cold start): the port's incumbent,
    warm and cold traces within 1e-5 of the reference's, and its iteration
    counts to 1e-3 within one of the reference's (23 warm, 10 cold). No
    order between warm and cold is asserted."""
    p = shifted_problem
    q_true64 = np.linalg.eigh(p["covs_post"].astype(np.float64).sum(0))[1]
    _, jq_true = jlinalg.eigh_topr(jnp.asarray(p["covs_post"]).sum(0), R)
    q_true = torch.from_numpy(np.array(jq_true))
    assert float(np.linalg.norm(q_true64[:, ::-1][:, :R].T
                                @ np.asarray(jq_true))) == pytest.approx(
        np.sqrt(R), abs=1e-4)
    warm_q = run_monolithic(_prog(p["covs_pre"], p["engine"], _j_init(3),
                                  t_outer=20)).q_nodes.mean(dim=0)
    jwarm = jruntime.run_monolithic(_jprog(
        p["covs_pre"], p["jengine"], _j_init(3), t_outer=20)
    ).q_nodes.mean(axis=0)
    assert np.abs(warm_q.numpy() - np.asarray(jwarm)).max() <= Q_ATOL
    runs = {}
    for name, init, jinit in (("cold", _j_init(4), _j_init(4)),
                              ("warm", warm_q.numpy(), np.asarray(jwarm))):
        got = run_monolithic(_prog(p["covs_post"], p["engine"], init, q_true,
                                   t_outer=30)).error_trace
        want = jruntime.run_monolithic(_jprog(
            p["covs_post"], p["jengine"], jinit, jq_true,
            t_outer=30)).error_trace
        assert np.abs(got - np.asarray(want)).max() <= TRACE_ATOL
        runs[name] = (_iterations(got), _iterations(want))
    assert runs["warm"][1] == 23 and runs["cold"][1] == 10, runs
    for got, want in runs.values():
        assert abs(got - want) <= 1, runs


@pytest.mark.parametrize("kill_at", [1, 2, 3])
def test_resolve_kill_at_chunk_boundary_resumes_bitwise(
        tmp_path, shifted_problem, kill_at):
    p = shifted_problem
    q_init = _j_init(7)
    ref = run_monolithic(_prog(p["covs_post"], p["engine"], q_init))
    mgr = CheckpointManager(str(tmp_path))
    run_chunked(_prog(p["covs_post"], p["engine"], q_init), mgr,
                chunk_size=CHUNK, max_chunks=kill_at)       # the "kill"
    res = run_chunked(_prog(p["covs_post"], p["engine"], q_init), mgr,
                      chunk_size=CHUNK)                     # the relaunch
    assert torch.equal(res.q_nodes, ref.q_nodes)
    assert np.array_equal(res.consensus_trace, ref.consensus_trace)


def test_target_step_increments_are_idempotent(tmp_path, shifted_problem):
    p = shifted_problem
    q_init = _j_init(8)
    ref = run_monolithic(_prog(p["covs_post"], p["engine"], q_init))
    mgr = CheckpointManager(str(tmp_path))
    for target in (3, 6, 6, 9, 6, 12):      # repeats/regressions: no-ops
        res = run_chunked(_prog(p["covs_post"], p["engine"], q_init), mgr,
                          chunk_size=CHUNK, target_step=target)
    assert mgr.latest_step() == T_OUTER
    assert torch.equal(res.q_nodes, ref.q_nodes)


# ---------------------------------------------------------------------------
# drift detector
# ---------------------------------------------------------------------------
def test_drift_detector_triggers_on_the_references_ticks(shifted_problem):
    """Both ingestors fed the reference's batches and Ritz init; the served
    Q is the reference's tracked basis at step 6. Read every tick through
    the shift: the same residuals (1e-5), gaps and trigger ticks."""
    jfn = shifted_problem["jfn"]
    port = StreamingIngestor(n_nodes=N, d=D, batch_fn=_np_fn(jfn),
                             batch_size=32, track_top=R,
                             ritz_init=_j_init(0, D, R + 1), device=CPU)
    ref = jingest.StreamingIngestor(n_nodes=N, d=D, batch_fn=jfn,
                                    batch_size=32, track_top=R)
    port.ingest(6)
    ref.ingest(6)
    served = np.asarray(ref.top_basis())
    det = DriftDetector(residual_threshold=0.3, warmup=2)
    jdet = jdrift.DriftDetector(residual_threshold=0.3, warmup=2)
    got, want = [], []
    for tick in range(12):
        port.ingest(1)
        ref.ingest(1)
        a = det.read(port, torch.as_tensor(served), baseline_gap=1.0,
                     ticks_since_swap=tick)
        b = jdet.read(ref, jnp.asarray(served), baseline_gap=1.0,
                      ticks_since_swap=tick)
        assert a.residual == pytest.approx(b.residual, abs=1e-5)
        assert a.eigengap == pytest.approx(b.eigengap, abs=1e-5)
        got.append(a.triggered)
        want.append(b.triggered)
    assert got == want and any(want) and not all(want)
    gap = DriftDetector(residual_threshold=2.0, gap_shift_threshold=0.1,
                        warmup=0)
    assert gap.read(port, torch.as_tensor(served), baseline_gap=100.0,
                    ticks_since_swap=0).triggered


# ---------------------------------------------------------------------------
# query path
# ---------------------------------------------------------------------------
class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeHooks:
    """query_delay stand-in: a fixed delay for odd req_ids."""

    def query_delay(self, req_id):
        return 1.0 if req_id % 2 else 0.0


def test_query_path_sheds_expires_and_matches_the_reference():
    """Shedding on a full queue, injected delays expiring against the
    deadline, queued requests drained past it, and the answers: the port's
    summary equals the reference's under the same fake clock."""
    q = _j_init(0)
    x = np.arange(D, dtype=np.float32)
    sums = []
    for mod, dev in ((QueryPath, {"device": CPU}), (jquery.QueryPath, {})):
        clock = _FakeClock()
        qp = mod(capacity=3, max_batch=2, deadline_s=0.5, hooks=_FakeHooks(),
                 clock=clock, **dev)
        accepted = [qp.submit(i, x * (i + 1)) for i in range(5)]
        assert accepted == [True, True, True, False, False]
        out = qp.process(q)
        assert [rid for rid, _ in out] == [0]          # 1 expired (delay)
        np.testing.assert_allclose(out[0][1], q.T @ x, rtol=1e-5, atol=1e-5)
        clock.t += 1.0                                  # 2 past deadline
        assert qp.drain_expired() == 1 and len(qp) == 0
        assert qp.process(q) == []
        sums.append(qp.summary())
    assert sums[0] == sums[1]
    assert sums[0]["shed"] == 2 and sums[0]["expired"] == 2
    rec = QueryPath(mode="reconstruct", device=CPU)
    rec.warmup(D, R)
    rec.submit(0, x)
    np.testing.assert_allclose(rec.process(torch.as_tensor(q))[0][1],
                               q @ (q.T @ x), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="query mode"):
        QueryPath(mode="rotate", device=CPU)


# ---------------------------------------------------------------------------
# the service loop
# ---------------------------------------------------------------------------
def _small_cfg(**kw):
    return ServiceConfig(**{**dict(
        d=10, r=2, n_nodes=4, batch_size=24, gap=0.6, lead=3.0,
        shift_lead=6.0, shift_at=5, holdout_m=256, total_ticks=14,
        t_outer=8, t_c=10, resolve_chunk=2, chunks_per_tick=2,
        topology={"kind": "er", "n": 4, "p": 0.6, "seed": 1},
        warmup_ticks=1, drift_threshold=0.3, drift_warmup=2,
        queries_per_tick=4, max_batch=4, staleness_bound=12, keep_last=3),
        **kw})


def _ref_draws(cfg):
    """The reference service's own draws, for the port."""
    jfn, _, _ = jpipe.drifting_eigengap_stream(
        cfg.d, cfg.r, cfg.gap, cfg.shift_at, seed=cfg.stream_seed,
        lead=cfg.lead, shift_lead=cfg.shift_lead)
    return ServiceDraws(
        batch_fn=_np_fn(jfn), served_q0=_j_init(cfg.seed, cfg.d, cfg.r),
        ritz_init=_j_init(cfg.seed, cfg.d, cfg.r + 1),
        cold_qinit=lambda rid: _j_init(cfg.seed * 7 + 100 + rid, cfg.d,
                                       cfg.r))


def test_service_config_round_trips_with_the_references(tmp_path):
    cfg = _small_cfg(topology={"kind": "ring", "n": 4})
    back = jservice.ServiceConfig.from_json(
        cfg.to_json(str(tmp_path / "p.json")))
    assert back == jservice.ServiceConfig(**json.load(
        open(tmp_path / "p.json")))
    fwd = ServiceConfig.from_json(back.to_json(str(tmp_path / "j.json")))
    assert fwd == cfg


@pytest.mark.parametrize("plan", [None, [
    {"kind": "corrupt_candidate", "mode": "nan", "resolve": 1}]],
    ids=["fault_free", "nan_candidate"])
def test_service_trajectory_equals_the_references(tmp_path, plan):
    """On the reference's draws, tick by tick: the same swap and reject
    ticks, and after every tick a served subspace within 1e-5 of the
    reference's (the gate's numpy draws are shared)."""
    cfg = _small_cfg()
    port = PSAService(cfg, str(tmp_path / "port"), device=CPU,
                      draws=_ref_draws(cfg),
                      plan=None if plan is None else FaultPlan(plan))
    ref = jservice.PSAService(
        cfg, str(tmp_path / "ref"),
        plan=None if plan is None else jservice.FaultPlan(plan))
    for tick in range(cfg.total_ticks):
        port.run(until=tick + 1)
        ref.run(until=tick + 1)
        assert np.abs(port.served_q - ref.served_q).max() <= Q_ATOL, tick
        assert (port.swaps, port.gate_rejects) == (ref.swaps,
                                                   ref.gate_rejects)
    port.finalize()
    ref.finalize()
    got = service_summary(str(tmp_path / "port"))
    want = jservice.service_summary(str(tmp_path / "ref"))
    for key in ("swap_ticks", "reject_ticks", "swaps", "gate_rejects",
                "cold_resolves", "max_staleness", "served_at"):
        assert got[key] == want[key], key
    assert got["swaps"] >= 2
    assert bool(got["reject_ticks"]) == (plan is not None)


def test_service_stop_and_resume_is_bitwise(tmp_path):
    """The port's own draws: stopped at tick 6 and resumed by a fresh
    service, the same served bits and swap ticks as the uninterrupted run;
    the pinned last-good step survives GC and matches on restore."""
    cfg = _small_cfg()
    ref_dir = str(tmp_path / "ref")
    PSAService(cfg, ref_dir, device=CPU).run().finalize()
    ref = service_summary(ref_dir)
    assert ref["swaps"] >= 2 and ref["gate_rejects"] == 0, ref
    assert ref["max_staleness"] <= cfg.staleness_bound, ref
    assert ref["queries"]["answered"] > 0 and ref["queries"]["shed"] == 0
    res_dir = str(tmp_path / "resume")
    PSAService(cfg, res_dir, device=CPU).run(until=6)
    PSAService(cfg, res_dir, device=CPU).run().finalize()
    res = service_summary(res_dir)
    assert res["served_sha256"] == ref["served_sha256"], (res, ref)
    assert res["swap_ticks"] == ref["swap_ticks"], (res, ref)
    assert res["restores"] and all(
        e["pinned_match"] is not False for e in res["restores"]), res
    mgr = CheckpointManager(os.path.join(res_dir, "state"),
                            keep_last=cfg.keep_last)
    assert mgr.pinned_steps() == [ref["served_at"]]
    assert ref["served_at"] in mgr.all_steps()
    with open(os.path.join(ref_dir, "obs", "metrics.service.json")) as f:
        dump = json.load(f)
    assert dump["query_latency_seconds"]["count"] == \
        ref["queries"]["answered"]
    assert dump["span_ingest_seconds"]["count"] == cfg.total_ticks


@pytest.mark.parametrize("mode", ["nan", "scale"])
def test_service_gate_rejects_a_mangled_candidate(tmp_path, mode):
    """A mangled candidate is never served: the gate rejects it, the
    incumbent keeps serving, and a cold re-solve recovers."""
    cfg = _small_cfg()
    plan = FaultPlan([{"kind": "corrupt_candidate", "mode": mode,
                       "resolve": 1}])
    svc = PSAService(cfg, str(tmp_path), plan=plan, device=CPU).run()
    svc.finalize()
    s = service_summary(str(tmp_path))
    assert s["gate_rejects"] == 1 and s["cold_resolves"] == 1, s
    assert s["swaps"] >= 2 and s["reject_ticks"], s
    assert np.all(np.isfinite(svc.served_q))
    np.testing.assert_allclose(svc.served_q.T @ svc.served_q, np.eye(cfg.r),
                               atol=1e-4)
    assert torch.equal(svc.served.device, torch.from_numpy(svc.served_q))


def test_supervised_run_survives_a_kill_and_a_hang(tmp_path):
    """``run_supervised`` on the CPU (``--device cpu`` in the child): a
    SIGKILL at tick 3's save and a wedge at tick 7 cost two relaunches,
    and the served bits and swap ticks equal the in-process run's."""
    cfg = _small_cfg()
    inproc = str(tmp_path / "inproc")
    PSAService(cfg, inproc, device=CPU).run().finalize()
    want = service_summary(inproc)
    work = str(tmp_path / "sup")
    os.makedirs(work)
    plan = FaultPlan([{"kind": "kill", "worker": "service", "boundary": 3},
                      {"kind": "hang", "worker": "service", "boundary": 7,
                       "sleep": 60}]).dump(os.path.join(work, "plan.json"))
    env = {**os.environ, tservice.ENV_PLAN: plan, "REPRO_OBS": "0"}
    got = tservice.run_supervised(cfg, work, device=CPU, env=env,
                                  stall_timeout=2.0, poll=0.1, backoff=0.05)
    assert got["relaunches"] == 2 and got["attempts"] == 3, got
    assert got["served_sha256"] == want["served_sha256"]
    assert got["swap_ticks"] == want["swap_ticks"]
    assert [e["tick"] for e in got["restores"]] == [2, 6]


def test_reference_snapshots_are_refused(tmp_path):
    """A reference service's snapshots index the reference's stream: the
    port refuses them (and snapshots of its own stream under injected
    draws, or the reverse) instead of resuming."""
    cfg = _small_cfg()
    work = str(tmp_path / "ref")
    jservice.PSAService(cfg, work).run(until=2)
    with pytest.raises(ValueError, match="JAX reference"):
        PSAService(cfg, work, device=CPU)
    own = str(tmp_path / "own")
    PSAService(cfg, own, device=CPU).run(until=1)
    with pytest.raises(ValueError, match="stream"):
        PSAService(cfg, own, device=CPU, draws=_ref_draws(cfg))


def test_main_without_device_needs_a_card(tmp_path):
    """The CLI's default device is CUDA: with no card it raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    spec = _small_cfg().to_json(str(tmp_path / "service.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tservice.main(["--run", spec, "--workdir", str(tmp_path)])
