"""The port's sweep fleet on the CPU: launcher, workers, leases, the rest of
chaos and the ``psa_sweep`` CLI, against the JAX reference where the two
share a format or a rule (twins of the launcher tests of
``tests/test_streaming.py`` and the lease and fleet tests of
``tests/test_chaos.py``; the smoke run and the obs CLI are in
``test_torch_chaos_smoke.py``).

Everything that spawns uses the chaos smoke's problem (d = 16, 6 nodes) and
at most 2 worker processes. Tolerances: a merged launch against the port's
own single-process sweep over each shard's seeds is bitwise (the lanes of
a shard are the lanes of that sweep); fingerprints, lease outcomes,
and validator verdicts are compared exactly.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.streaming import chaos as j_chaos
from repro.streaming import fleet as j_fleet
from repro.streaming.launcher import spec_fingerprint as j_fingerprint
from repro_torch.checkpoint.manager import CheckpointManager, save_tree
from repro_torch.core.linalg import eigh_topr
from repro_torch.core.sweep import sdot_sweep, slice_seed_shards
from repro_torch.data.pipeline import eigengap_stream
from repro_torch.streaming import chaos
from repro_torch.streaming import fleet
from repro_torch.streaming.ingest import StreamingIngestor
from repro_torch.streaming.launcher import (_load_result, _result_dir,
                                            build_engine, build_schedule,
                                            launch_sweep, spec_fingerprint)
from repro_torch.streaming.worker import run_shard

D, R, N, T_C = 16, 3, 6, 10
CASES = [{"topology": {"kind": "er", "n": N, "p": 0.5, "seed": 1},
          "schedule": {"kind": "lin2", "cap": T_C}}]


@pytest.fixture(scope="module")
def prob():
    batch_fn, _, _ = eigengap_stream(D, R, 0.7, seed=0, device="cpu")
    ing = StreamingIngestor(n_nodes=N, d=D, batch_fn=batch_fn,
                            batch_size=30, device="cpu")
    ing.ingest(10)
    covs = ing.cov_stack()
    return dict(covs=covs, q_true=eigh_topr(covs.sum(0), R)[1])


def _ref(prob, seeds, n_shards, t_outer):
    """The port's single-process sweep over each shard's seeds."""
    engines = [build_engine(c["topology"], device="cpu") for c in CASES]
    scheds = [build_schedule(c["schedule"], t_outer, T_C) for c in CASES]
    parts = [sdot_sweep(covs=prob["covs"], engines=engines, schedules=scheds,
                        r=R, t_outer=t_outer, t_c=T_C, seeds=s,
                        q_true=prob["q_true"], device="cpu")
             for s in slice_seed_shards(seeds, n_shards)]
    return (np.concatenate([p.error_traces for p in parts], axis=0),
            torch.cat([p.q for p in parts]), parts)


def _assert_merge(sw, ref):
    err, q, parts = ref
    np.testing.assert_array_equal(sw.error_traces, err)
    assert torch.equal(sw.q, q)
    ledger = parts[0].ledger
    for p in parts[1:]:
        ledger = ledger.merged(p.ledger)
    assert sw.ledger.p2p == ledger.p2p and sw.ledger.scalars == ledger.scalars


def _launch(prob, workdir, **kw):
    args = dict(covs=prob["covs"], cases=CASES, r=R, t_outer=6, t_c=T_C,
                seeds=[0, 1, 2, 3], q_true=prob["q_true"],
                workdir=str(workdir), n_workers=2, device="cpu")
    args.update(kw)
    return launch_sweep(**args)


# ---------------------------------------------------------------------------
# the spec's fingerprint
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [
    {}, {"sweep_chunk": 3}, {"t_outer": 7}, {"ragged": True,
                                             "n_cov_stacks": 2},
    {"net_faults": {"p_drop": 0.2, "seed": 11}},
    {"operand": "data", "n_blocks": 6}])
def test_spec_fingerprint_equals_the_reference(extra):
    spec = {"algo": "sdot", "r": R, "t_outer": 6, "t_c": T_C,
            "cases": CASES, "shards": [[0, 1], [2, 3]], "ragged": False,
            "n_cov_stacks": 1, "has_q_true": True, "sweep_chunk": None}
    spec.update(extra)
    assert spec_fingerprint(spec) == j_fingerprint(spec)
    base = dict(spec, sweep_chunk=None)
    assert spec_fingerprint(spec) == spec_fingerprint(base)


# ---------------------------------------------------------------------------
# leases and heartbeats: the reference's scenarios, and its files
# ---------------------------------------------------------------------------
def test_lease_fencing_tokens(tmp_path):
    """The reference's scenario: a live lease refuses a claimant, an expired
    one is stolen with the token raised, the victim's renewal raises, a
    release makes it acquirable, and the owner history shows the steal."""
    store = fleet.LeaseStore(str(tmp_path), ttl=0.3)
    l1 = store.try_acquire(0, "a")
    assert l1 is not None and l1.token == 1
    assert store.try_acquire(0, "b") is None
    store.renew(0, "a", l1.token)
    time.sleep(0.4)
    l2 = store.try_acquire(0, "b")
    assert l2 is not None and l2.token == 2
    with pytest.raises(fleet.LeaseLost):
        store.renew(0, "a", l1.token)
    store.release(0, "b", l2.token, done=True)
    l3 = store.try_acquire(0, "c")
    assert l3.token == 3 and l3.owners == ["a", "b", "c"]


def test_lease_files_are_shared_with_the_reference(tmp_path):
    """A lease the reference wrote is read, renewed and stolen by the port's
    store with the same tokens, and the other way round."""
    j_store = j_fleet.LeaseStore(str(tmp_path), ttl=0.3)
    t_store = fleet.LeaseStore(str(tmp_path), ttl=0.3)
    lease = j_store.try_acquire(0, "ref")
    t_lease = t_store.read(0)
    assert dict(t_lease) == dict(lease) and t_lease.token == 1
    assert t_store.try_acquire(0, "port") is None      # live foreign lease
    time.sleep(0.4)
    stolen = t_store.try_acquire(0, "port")
    assert stolen.token == 2
    with pytest.raises(j_fleet.LeaseLost):
        j_store.renew(0, "ref", lease.token)
    assert j_store.read(0).owners == ["ref", "port"]


def test_lease_pick_prefers_own_then_never_leased_then_stalest(tmp_path):
    store = fleet.LeaseStore(str(tmp_path), ttl=0.2)
    store.try_acquire(0, "a")
    time.sleep(0.3)
    store.try_acquire(1, "b")
    time.sleep(0.25)
    assert store.pick([0, 1, 2], "b") == 1
    assert store.pick([0, 1, 2], "z") == 2
    assert store.pick([0, 1], "z") == 0


def test_lease_expiry_survives_clock_jumps(tmp_path):
    """The monotonic stamp decides where it is coherent (wall jumps cannot
    make a dead lease immortal or a live one stealable); a stamp from
    another boot, or none, falls back to the wall clock."""
    store = fleet.LeaseStore(str(tmp_path), ttl=30.0)
    lease = store.try_acquire(0, "a")
    lease["renewed_at"] = time.time() + 3600.0
    lease["renewed_mono"] = time.monotonic() - 100.0
    store._write(0, dict(lease))
    assert store.read(0).expired(30.0)
    assert store.try_acquire(0, "b") is not None
    lease2 = store.try_acquire(1, "a")
    lease2["renewed_at"] = time.time() - 3600.0
    lease2["renewed_mono"] = time.monotonic()
    store._write(1, dict(lease2))
    assert not store.read(1).expired(30.0)
    assert store.try_acquire(1, "b") is None
    legacy = fleet.Lease({"owner": "a", "token": 1, "renewed_at": time.time(),
                        "owners": ["a"]})
    store._write(2, dict(legacy))
    assert not store.read(2).expired(30.0)
    store._write(3, dict(legacy, renewed_at=time.time() - 100.0,
                         renewed_mono=time.monotonic() + 9e5))
    assert store.read(3).expired(30.0)


def test_heartbeat_round_trip_with_the_reference(tmp_path):
    hb = str(tmp_path / "w" / "heartbeat")
    assert fleet.heartbeat_age(hb) is None
    fleet.touch_heartbeat(hb, step=7)
    assert fleet.heartbeat_age(hb) < 5.0
    assert j_fleet.read_heartbeat(hb)["step"] == 7
    j_fleet.touch_heartbeat(hb, step=9)
    assert fleet.read_heartbeat(hb)["step"] == 9


# ---------------------------------------------------------------------------
# chaos: validators, hooks, drop, the smoke run
# ---------------------------------------------------------------------------
NET_DOCS = [
    {}, {"seed": 3, "p_drop": 0.2, "debias": "nominal"},
    {"burst": {"p_bad": 0.05, "p_good": 0.5},
     "corrupt": {"p": 0.01, "mode": "nan", "scale": 1e9, "guard": 1e6},
     "crash": [{"node": 0, "start": 2, "len": 3}]},
    {"p_drop": 1.5}, {"p_drop": True}, {"seed": 1.5}, {"bogus": 1},
    {"burst": {"p_bad": 0.1, "p_good": 0.0}}, {"burst": {"p_x": 0.1}},
    {"corrupt": {"mode": "zero"}}, {"corrupt": {"scale": -1.0}},
    {"crash": [{"node": 0, "start": 1}]}, {"crash": [{"node": 0, "start": 1,
                                                     "len": 0}]},
    {"crash": "x"}, {"debias": "exact"}, [1, 2]]


@pytest.mark.parametrize("doc", NET_DOCS, ids=[str(i) for i in
                                               range(len(NET_DOCS))])
def test_net_fault_validator_agrees_with_the_reference(doc):
    def verdict(fn):
        try:
            fn(doc)
            return "ok"
        except ValueError as e:
            return str(e)
    assert verdict(chaos.validate_net_fault_doc) == \
        verdict(j_chaos.validate_net_fault_doc)
    if verdict(chaos.validate_net_fault_doc) == "ok":
        model, seed, debias = chaos.net_fault_model_from_dict(doc)
        j_model, j_seed, j_debias = j_chaos.net_fault_model_from_dict(doc)
        assert (seed, debias) == (j_seed, j_debias)
        for field in ("p_drop", "p_bad", "p_good", "p_corrupt",
                      "corrupt_mode", "corrupt_scale", "guard_norm",
                      "crash_windows"):
            assert getattr(model, field) == getattr(j_model, field)


def test_plan_files_and_env_entry_points(tmp_path, monkeypatch, capsys):
    """``validate_plan_file`` gives the reference's exit codes and lines on
    the repo's plans and on broken ones; ``net_faults_from_env`` reads a
    path or inline JSON; ``hooks_from_env`` is inert without a plan."""
    bad_json = tmp_path / "bad.json"
    bad_json.write_text('{"faults": [')
    bad_kind = tmp_path / "kind.json"
    bad_kind.write_text(json.dumps({"faults": [{"kind": "explode"}]}))
    for path in ("examples/net_faults.json", "examples/chaos_plan.json",
                 str(bad_json), str(bad_kind), str(tmp_path / "none.json")):
        rc = chaos.validate_plan_file(path)
        out = capsys.readouterr().out
        assert rc == j_chaos.validate_plan_file(path)
        assert out == capsys.readouterr().out
    monkeypatch.setenv(chaos.ENV_NET, '{"p_drop": 0.1}')
    assert chaos.net_faults_from_env() == {"p_drop": 0.1}
    monkeypatch.setenv(chaos.ENV_NET, "examples/net_faults.json")
    assert chaos.net_faults_from_env() == j_chaos.net_faults_from_env()
    monkeypatch.delenv(chaos.ENV_PLAN, raising=False)
    hooks = chaos.hooks_from_env(shard=0, workdir=str(tmp_path))
    assert not hooks.active
    hooks.at_boundary(1)
    hooks.after_publish(str(tmp_path))
    assert os.path.isdir(tmp_path)


def test_drop_fires_once_after_publish(tmp_path, monkeypatch):
    """A ``drop`` fault deletes the published result once; the relaunch
    (a second hooks object over the same state directory) keeps it."""
    plan_path = chaos.FaultPlan([{"kind": "drop", "shard": 3}]).dump(
        str(tmp_path / "plan.json"))
    monkeypatch.setenv(chaos.ENV_PLAN, plan_path)
    for attempt in range(2):
        out = tmp_path / "worker_3" / "result"
        out.mkdir(parents=True, exist_ok=True)
        hooks = chaos.hooks_from_env(shard=3, worker="3",
                                     workdir=str(tmp_path))
        hooks.at_boundary(1)                     # drop never fires here
        assert out.exists()
        hooks.after_publish(str(out))
        assert out.exists() == (attempt == 1)
    other = chaos.hooks_from_env(shard=2, workdir=str(tmp_path))
    out2 = tmp_path / "worker_2" / "result"
    out2.mkdir(parents=True)
    other.after_publish(str(out2))
    assert out2.exists()                         # another shard: untouched


# ---------------------------------------------------------------------------
# the launcher against the single-process sweep
# ---------------------------------------------------------------------------
def test_launcher_matches_single_process_and_resumes_mid_grid(tmp_path,
                                                              prob):
    """Pinned, 2 workers: the merge equals each shard's single-process sweep
    bit for bit; a worker whose checkpoint holds step 3 of its shard resumes
    there with the same bits; a rerun reuses every published shard, and a
    changed spec relaunches."""
    seeds = [0, 1, 2, 3]
    ref = _ref(prob, seeds, 2, 6)
    full = _launch(prob, tmp_path / "full", sweep_chunk=3)
    _assert_merge(full, ref)
    assert full.resume_report["worker_resumed_steps"] == {0: 0, 1: 0}

    wd = tmp_path / "killed"
    mgr = CheckpointManager(str(wd / "worker_0" / "ckpt"))
    sdot_sweep(covs=prob["covs"],
               engines=[build_engine(CASES[0]["topology"], device="cpu")],
               schedules=[build_schedule(CASES[0]["schedule"], 6, T_C)],
               r=R, t_outer=6, t_c=T_C, seeds=seeds[:2],
               q_true=prob["q_true"], device="cpu", manager=mgr,
               chunk_size=3, max_chunks=1)
    res = _launch(prob, wd, sweep_chunk=3)
    assert res.resume_report["worker_resumed_steps"] == {0: 3, 1: 0}
    _assert_merge(res, ref)
    again = _launch(prob, wd, sweep_chunk=3)
    assert again.resume_report["reused_shards"] == [0, 1]
    assert again.resume_report["skipped_grid_points"] == len(seeds)
    np.testing.assert_array_equal(again.error_traces, res.error_traces)
    shorter = _launch(prob, wd, t_outer=4)
    assert shorter.resume_report["reused_shards"] == []
    np.testing.assert_array_equal(shorter.error_traces,
                                  ref[0][:, :4])


def test_launcher_on_raw_data_blocks(tmp_path):
    """Raw (d, n_i) blocks instead of covs (Step 5 through the gram-apply
    path): the spec gains ``operand``, and the merge equals the
    single-process sweeps of each shard's seeds bit for bit."""
    from repro_torch.data.pipeline import (gaussian_eigengap_data,
                                           partition_samples)
    x, _, _ = gaussian_eigengap_data(D, 600, R, 0.7, seed=0, device="cpu")
    blocks = partition_samples(x, N)
    q_true = eigh_topr(x @ x.T, R)[1]
    sw = launch_sweep(data=blocks, cases=CASES, r=R, t_outer=5, t_c=T_C,
                      seeds=[0, 1, 2], q_true=q_true, workdir=str(tmp_path),
                      n_workers=2, device="cpu")
    with open(tmp_path / "spec.json") as f:
        assert json.load(f)["operand"] == "data"
    engines = [build_engine(CASES[0]["topology"], device="cpu")]
    scheds = [build_schedule(CASES[0]["schedule"], 5, T_C)]
    parts = [sdot_sweep(data=blocks, engines=engines, schedules=scheds, r=R,
                        t_outer=5, t_c=T_C, seeds=s, q_true=q_true,
                        device="cpu")
             for s in slice_seed_shards([0, 1, 2], 2)]
    np.testing.assert_array_equal(
        sw.error_traces, np.concatenate([p.error_traces for p in parts]))
    assert torch.equal(sw.q, torch.cat([p.q for p in parts]))
    with pytest.raises(ValueError, match="exactly one"):
        launch_sweep(cases=CASES, r=R, t_outer=5, seeds=[0],
                     workdir=str(tmp_path / "none"), device="cpu")


def test_elastic_launch_and_a_joiner_stealing_an_expired_lease(tmp_path,
                                                               prob):
    """A worker that left mid-shard (an expired lease, a checkpoint at step
    2) loses the shard to one that joins: the joiner steals the lease (the
    token raised), resumes the checkpoint and publishes; an elastic launch
    over the same workdir merges both shards bit for bit."""
    seeds, t_outer = [0, 1, 2, 3], 6
    shards = slice_seed_shards(seeds, 2)
    spec = {"algo": "sdot", "r": R, "t_outer": t_outer, "t_c": T_C,
            "cases": CASES, "shards": shards, "ragged": False,
            "n_cov_stacks": 1, "has_q_true": True, "sweep_chunk": 2}
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    np.savez(tmp_path / "problem.npz", covs=prob["covs"].numpy(),
             q_true=prob["q_true"].numpy())
    mgr = CheckpointManager(str(tmp_path / "worker_0" / "ckpt"))
    sdot_sweep(covs=prob["covs"],
               engines=[build_engine(CASES[0]["topology"], device="cpu")],
               schedules=[build_schedule(CASES[0]["schedule"], t_outer,
                                         T_C)],
               r=R, t_outer=t_outer, t_c=T_C, seeds=shards[0],
               q_true=prob["q_true"], device="cpu", manager=mgr,
               chunk_size=2, max_chunks=1)
    store = fleet.LeaseStore(str(tmp_path), ttl=0.3)
    departed = store.try_acquire(0, "departed")
    time.sleep(0.4)
    assert fleet.fleet_worker_loop(spec, str(tmp_path), "joiner", ttl=0.3,
                                   device="cpu") == 0
    snap = store.snapshot()
    assert snap[0].owners == ["departed", "joiner"]
    assert snap[0].token == departed.token + 1
    assert int(_load_result(str(tmp_path), spec, 0)["resumed_steps"]) == 2
    sw = _launch(prob, tmp_path, t_outer=t_outer, sweep_chunk=2,
                 elastic=True, lease_ttl=5.0)
    assert sw.resume_report["reused_shards"] == [0, 1]
    assert sw.resume_report["stolen_shards"] == [0]
    _assert_merge(sw, _ref(prob, seeds, 2, t_outer))
    fresh = _launch(prob, tmp_path / "elastic", t_outer=t_outer,
                    elastic=True, lease_ttl=5.0)
    _assert_merge(fresh, _ref(prob, seeds, 2, t_outer))


def test_foreign_results_are_refused_not_merged(tmp_path, prob):
    """A result the reference published for the same spec (its lanes start
    from jax.random draws), or the port's from the other device type, is
    refused with an error; a worker with no card raises."""
    seeds = [0, 1]
    wd = tmp_path / "wd"
    sw = _launch(prob, wd, seeds=seeds, n_workers=1, t_outer=4)
    with open(wd / "spec.json") as f:
        spec = json.load(f)
    tree = {"q": sw.q, "seeds": torch.tensor(seeds), "ledger": sw.ledger,
            "resumed_steps": torch.tensor(0, dtype=torch.int32),
            "spec_fp": torch.tensor(spec_fingerprint(spec),
                                    dtype=torch.int32),
            "error_traces": torch.from_numpy(sw.error_traces)}
    save_tree(_result_dir(str(wd), 0), tree, step=0)      # no port_device
    with pytest.raises(ValueError, match="JAX reference"):
        _launch(prob, wd, seeds=seeds, n_workers=1, t_outer=4)
    save_tree(_result_dir(str(wd), 0),
              dict(tree, port_device=torch.tensor(1, dtype=torch.int32)),
              step=0)
    with pytest.raises(ValueError, match="published on cuda"):
        _launch(prob, wd, seeds=seeds, n_workers=1, t_outer=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_shard(spec, str(wd), 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fleet.fleet_worker_loop(spec, str(wd), "w0", ttl=1.0)


def test_psa_sweep_cli(tmp_path, capsys):
    """``python -m repro_torch.launch.psa_sweep`` end to end on the CPU: the
    stream, a chunked 2-worker launch, and its JSON summary."""
    from repro_torch.launch.psa_sweep import main
    assert main(["--d", "12", "--nodes", "6", "--r", "3", "--seeds", "2",
                 "--workers", "2", "--t-outer", "6", "--batches", "5",
                 "--resume", "--sweep-chunk", "3", "--device", "cpu",
                 "--workdir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["seeds"] == 2
    assert out["resume"]["attempts"] == {"0": 1, "1": 1}
    assert 0.0 <= out["final_err_mean"] < 1.0
