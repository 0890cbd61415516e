"""The port's Monte-Carlo sweep engine (``repro_torch.core.sweep``) on the
CPU: twins of the sweep cases of ``tests/test_fused_zoo.py`` and of
``tests/test_sweep_ragged.py``, plus the port's own contracts.

Every lane is held to the port's own single run from the same init (the
reference's sweeps differ from its per-seed runs by up to 2e-4 relative,
``test_fused_zoo.py``'s three known failures, so the port is not held to
those), and the port's sweeps to the reference's per-seed runs from the
reference's own inits. Tolerances:

* LANE_ATOL 1e-6 (absolute, on traces and iterates): a lane against its
  single run. The lanes' gossip is a batched matmul and a ragged lane's
  mean is node-masked, so a product may sum in another order; on this CPU
  the unpadded lanes read exactly equal;
* TRACE_ATOL 1e-5 (absolute): the port against the reference, f32 on both
  sides with products summed in other orders (the runtime tests' limit);
* bitwise: a chunked sweep killed and resumed against the uninterrupted
  one, and a shard of seeds against those lanes of the full grid.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import consensus as jc
from repro.core import sweep as jsweep
from repro.core import sweep_utils as jsu
from repro.core import topology as jtopo
from repro.core.fdot import fdot as j_fdot
from repro.core.sdot import sdot as j_sdot
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import baselines as tb
from repro_torch.core import sweep as ts
from repro_torch.core import sweep_utils as tsu
from repro_torch.core import topology as ttopo
from repro_torch.core.consensus import DenseConsensus, consensus_schedule
from repro_torch.core.fdot import fdot
from repro_torch.core.metrics import CommLedger
from repro_torch.core.netfaults import FaultyConsensus, NetFaultModel
from repro_torch.core.sdot import sdot

LANE_ATOL = 1e-6
TRACE_ATOL = 1e-5
LEDGER_FIELDS = ("p2p", "matrices", "scalars", "payload_bytes")
SEEDS = [0, 1, 2]


def t32(a):
    return torch.tensor(np.asarray(a, np.float32))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def tengine(n, topo, **kw):
    graph = (ttopo.erdos_renyi(n, 0.5, seed=1) if topo == "er"
             else ttopo.ring(n))
    return DenseConsensus(graph, device="cpu", **kw)


def jengine(n, topo):
    return jc.DenseConsensus(jtopo.erdos_renyi(n, 0.5, seed=1)
                             if topo == "er" else jtopo.ring(n))


def assert_ledgers_equal(a, b):
    for f in LEDGER_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    assert a.awake_counts == b.awake_counts


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def prob(psa_problem):
    p = psa_problem
    return dict(d=p["d"], r=p["r"], n=p["n_nodes"], covs=p["covs"],
                q_true=p["q_true"], blocks=p["blocks"],
                t_covs=t32(p["covs"]), t_q_true=t32(p["q_true"]),
                t_blocks=[t32(b) for b in p["blocks"]])


@pytest.fixture(scope="module")
def fprob():
    from repro.core.linalg import eigh_topr
    from repro.data.pipeline import gaussian_eigengap_data, partition_features
    x, _, _ = gaussian_eigengap_data(20, 3000, 5, 0.7, seed=0)
    _, q_true = eigh_topr(x @ x.T, 5)
    blocks = partition_features(x, 10)
    return dict(blocks=blocks, q_true=q_true,
                t_blocks=[t32(b) for b in blocks], t_q_true=t32(q_true))


# ---------------------------------------------------------------------------
# sweep_utils and shards: the reference's helpers, the same values
# ---------------------------------------------------------------------------
def test_pad_weights_identity_isolates():
    w = np.full((3, 3), 1.0 / 3)
    out = tsu.pad_weights_identity(w, 5)
    np.testing.assert_array_equal(out, jsu.pad_weights_identity(w, 5))
    np.testing.assert_array_equal(out[:3, 3:], 0.0)
    np.testing.assert_array_equal(out[3:, 3:], np.eye(2))
    assert np.allclose(out.sum(1), 1.0)          # still doubly stochastic


def test_pad_helpers_match_reference():
    covs = np.arange(48, dtype=np.float32).reshape(3, 4, 4)
    np.testing.assert_array_equal(
        tsu.pad_covs_identity(torch.tensor(covs), 5).numpy(),
        np.asarray(jsu.pad_covs_identity(jnp.asarray(covs), 5)))
    slabs = np.ones((3, 6, 7), np.float32)
    np.testing.assert_array_equal(
        tsu.pad_zero_nodes(torch.tensor(slabs), 5).numpy(),
        np.asarray(jsu.pad_zero_nodes(jnp.asarray(slabs), 5)))
    np.testing.assert_array_equal(tsu.case_node_masks([3, 5], 5).numpy(),
                                  np.asarray(jsu.case_node_masks([3, 5], 5)))
    assert tsu.broadcast_per_case([1], 3, "x") == [1, 1, 1]
    with pytest.raises(ValueError, match="zip-broadcast"):
        tsu.broadcast_per_case([1, 2], 3, "x")


@pytest.mark.parametrize("n_shards", [1, 2, 3, 10])
def test_slice_seed_shards_match_reference(n_shards):
    seeds = [4, 8, 15, 16, 23, 42, 7]
    assert (ts.slice_seed_shards(seeds, n_shards)
            == jsweep.slice_seed_shards(seeds, n_shards))


# ---------------------------------------------------------------------------
# S-DOT sweeps: each lane is the port's own single run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["cov", "data"])
def test_sdot_sweep_lanes_match_per_seed_runs(prob, mode):
    """Two cases (ER under const, ring under lin2: per-lane budgets, each
    case held past its own budget) x three seeds, each lane against its
    single run; the ledger equals the per-seed ledgers' sum."""
    engines = [tengine(prob["n"], "er"), tengine(prob["n"], "ring")]
    schedules = [consensus_schedule("const", 10, t_max=30),
                 consensus_schedule("lin2", 10, cap=30)]
    operand = (dict(covs=prob["t_covs"]) if mode == "cov"
               else dict(data=prob["t_blocks"]))
    sw = ts.sdot_sweep(engines=engines, schedules=schedules, r=prob["r"],
                       t_outer=10, seeds=SEEDS, q_true=prob["t_q_true"],
                       **operand)
    assert sw.error_traces.shape == (2, 3, 10)
    led = CommLedger()
    for ci, (eng, sched) in enumerate(zip(engines, schedules)):
        for si, s in enumerate(SEEDS):
            res = sdot(engine=eng, r=prob["r"], t_outer=10, schedule=sched,
                       generator=gen(s), q_true=prob["t_q_true"],
                       device="cpu", **operand)
            led = led.merged(res.ledger)
            close(sw.error_traces[ci, si], res.error_trace, LANE_ATOL)
            close(sw.q[ci, si], res.q_nodes, LANE_ATOL)
    assert_ledgers_equal(sw.ledger, led)
    assert sw.mean_trace.shape == (2, 10) and sw.std_trace.shape == (2, 10)


def test_sdot_sweep_matches_reference(prob):
    """The reference's sweep (its own lanes are sound for S-DOT) from its
    own inits."""
    q_inits = np.asarray(jsweep._seed_inits(SEEDS, prob["d"], prob["r"]))
    sched = [consensus_schedule("const", 8, t_max=20),
             consensus_schedule("lin2", 8, cap=20)]
    ref = jsweep.sdot_sweep(covs=prob["covs"], engines=jengine(prob["n"],
                                                               "er"),
                            schedules=sched, r=prob["r"], t_outer=8,
                            seeds=SEEDS, q_true=prob["q_true"])
    sw = ts.sdot_sweep(covs=prob["t_covs"], engines=tengine(prob["n"], "er"),
                       schedules=sched, r=prob["r"], t_outer=8, seeds=SEEDS,
                       q_true=prob["t_q_true"], q_inits=t32(q_inits))
    close(sw.error_traces, ref.error_traces, TRACE_ATOL)
    assert_ledgers_equal(sw.ledger, ref.ledger)


def test_sdot_ragged_sweep_matches_unpadded_runs(prob):
    covs6 = prob["t_covs"][:6]
    engines = [DenseConsensus(ttopo.erdos_renyi(6, 0.6, seed=1),
                              device="cpu"), tengine(10, "ring")]
    sw = ts.sdot_sweep(covs=[covs6, prob["t_covs"]], engines=engines, r=4,
                       t_outer=8, t_c=20, seeds=SEEDS[:2],
                       q_true=prob["t_q_true"][:, :4])
    np.testing.assert_array_equal(sw.node_counts, [6, 10])
    for ci, (eng, cv) in enumerate(zip(engines, [covs6, prob["t_covs"]])):
        for si, s in enumerate(SEEDS[:2]):
            res = sdot(covs=cv, engine=eng, r=4, t_outer=8, t_c=20,
                       generator=gen(s), q_true=prob["t_q_true"][:, :4],
                       device="cpu")
            close(sw.error_traces[ci, si], res.error_trace, LANE_ATOL)
            close(sw.q[ci, si, :eng.graph.n_nodes], res.q_nodes, LANE_ATOL)


# ---------------------------------------------------------------------------
# F-DOT sweeps
# ---------------------------------------------------------------------------
def test_fdot_sweep_matches_per_seed_runs_and_reference(fprob):
    seeds = [0, 1]
    eng = tengine(10, "er")
    q_inits = np.asarray(jsweep._seed_inits(seeds, 20, 5))
    sw = ts.fdot_sweep(data_blocks=fprob["t_blocks"], engines=eng, r=5,
                       t_outer=8, t_c=30, seeds=seeds,
                       q_true=fprob["t_q_true"], q_inits=t32(q_inits))
    assert sw.error_traces.shape == (2, 8)
    led = CommLedger()
    for si, s in enumerate(seeds):
        res = fdot(data_blocks=fprob["t_blocks"], engine=eng, r=5, t_outer=8,
                   t_c=30, q_init=t32(q_inits[si]), q_true=fprob["t_q_true"],
                   device="cpu")
        led = led.merged(res.ledger)
        close(sw.error_traces[si], res.error_trace, LANE_ATOL)
        ref = j_fdot(data_blocks=fprob["blocks"], engine=jengine(10, "er"),
                     r=5, t_outer=8, t_c=30, q_init=jnp.asarray(q_inits[si]),
                     q_true=fprob["q_true"])
        close(sw.error_traces[si], ref.error_trace, TRACE_ATOL)
    assert_ledgers_equal(sw.ledger, led)


@pytest.fixture(scope="module")
def feature_cases():
    from repro_torch.data.pipeline import (gaussian_eigengap_data,
                                           partition_features)
    x, _, _ = gaussian_eigengap_data(18, 300, 4, 0.6, seed=2, device="cpu")
    q_true = torch.linalg.eigh((x @ x.T).double())[1][:, -4:].flip(-1)
    return dict(
        blocks=[partition_features(x, 3), partition_features(x, 5)],
        engines=[DenseConsensus(ttopo.erdos_renyi(3, 0.9, seed=1),
                                device="cpu"),
                 DenseConsensus(ttopo.ring(5), device="cpu")],
        q_true=q_true.float())


def test_fdot_ragged_sweep_matches_unpadded_runs(feature_cases):
    fc = feature_cases
    sw = ts.fdot_sweep(data_blocks=fc["blocks"], engines=fc["engines"], r=4,
                       t_outer=6, t_c=20, seeds=SEEDS[:2],
                       q_true=fc["q_true"])
    assert sw.error_traces.shape == (2, 2, 6)
    np.testing.assert_array_equal(sw.node_counts, [3, 5])
    led = CommLedger()
    for ci, (eng, blocks) in enumerate(zip(fc["engines"], fc["blocks"])):
        for si, s in enumerate(SEEDS[:2]):
            res = fdot(data_blocks=blocks, engine=eng, r=4, t_outer=6,
                       t_c=20, generator=gen(s), q_true=fc["q_true"],
                       device="cpu")
            led = led.merged(res.ledger)
            close(sw.error_traces[ci, si], res.error_trace, LANE_ATOL)
    assert_ledgers_equal(sw.ledger, led)


def test_fdot_ragged_rejects_mismatches(feature_cases):
    fc = feature_cases
    with pytest.raises(ValueError, match="node count"):
        ts.fdot_sweep(data_blocks=[fc["blocks"][0], fc["blocks"][0]],
                      engines=fc["engines"], r=4, t_outer=3, seeds=[0])
    short = [b[:-1] for b in fc["blocks"][1]]       # drops feature rows
    with pytest.raises(ValueError, match="same d features"):
        ts.fdot_sweep(data_blocks=[fc["blocks"][0], short],
                      engines=fc["engines"], r=4, t_outer=3, seeds=[0])


# ---------------------------------------------------------------------------
# baseline sweeps
# ---------------------------------------------------------------------------
BASELINE_KW = {"dsa": dict(t_outer=15, lr=0.05),
               "dpgd": dict(t_outer=15, lr=0.05),
               "deepca": dict(t_outer=15),
               "seq_dist_pm": dict(iters_per_vec=4, t_c=30)}


@pytest.mark.parametrize("name", ["dsa", "dpgd", "deepca", "seq_dist_pm",
                                  "d_pm"])
def test_baseline_sweep_matches_per_seed_runs_and_reference(prob, fprob,
                                                            name):
    seeds = [0, 1]
    eng, j_eng = tengine(10, "er"), jengine(10, "er")
    if name == "d_pm":
        kw = dict(iters_per_vec=5, t_c=30)
        r, q_true, j_q_true = 3, fprob["t_q_true"][:, :3], fprob["q_true"][:,
                                                                          :3]
        args, j_args = (fprob["t_blocks"],), (fprob["blocks"],)
        sweep_in = dict(data_blocks=fprob["t_blocks"])
        d = 20
    else:
        kw = BASELINE_KW[name]
        r, q_true, j_q_true = prob["r"], prob["t_q_true"], prob["q_true"]
        args, j_args = (prob["t_covs"],), (prob["covs"],)
        sweep_in = dict(covs=prob["t_covs"])
        d = prob["d"]
    sw = ts.baseline_sweep(name, engine=eng, r=r, seeds=seeds,
                           q_true=q_true, **sweep_in, **kw)
    led = CommLedger()
    for si, s in enumerate(seeds):
        q1, e1 = getattr(tb, name)(*args, eng, r, q_true=q_true, seed=s,
                                   ledger=led, device="cpu", **kw)
        close(sw.error_traces[si], e1, LANE_ATOL)
        close(sw.q[si], q1, LANE_ATOL)
        # the reference's single run from its own init (seed s)
        _, e_ref = getattr(jb, name)(*j_args, j_eng, r, q_true=j_q_true,
                                     seed=s, **kw)
        q_init = t32(jsweep._seed_inits([s], d, r)[0])
        _, e_port = getattr(tb, name)(*args, eng, r, q_true=q_true,
                                      q_init=q_init, device="cpu", **kw)
        close(e_port, e_ref, TRACE_ATOL)
    assert_ledgers_equal(sw.ledger, led)


@pytest.fixture(scope="module")
def cov_cases():
    from repro_torch.data.pipeline import (gaussian_eigengap_data,
                                           partition_samples)

    def problem(n_nodes, d=16, r=4, n_per=200):
        x, _, _ = gaussian_eigengap_data(d, n_nodes * n_per, r, 0.7, seed=0,
                                         device="cpu")
        covs = torch.stack([b @ b.T / b.shape[1]
                            for b in partition_samples(x, n_nodes)])
        q = torch.linalg.eigh(covs.sum(0).double())[1][:, -r:].flip(-1)
        return covs, q.float()

    covs6, q_true = problem(6)
    covs10, _ = problem(10)
    return dict(covs=[covs6, covs10], q_true=q_true,
                engines=[DenseConsensus(ttopo.erdos_renyi(6, 0.6, seed=1),
                                        device="cpu"),
                         DenseConsensus(ttopo.ring(10), device="cpu")])


@pytest.mark.parametrize("name", ["dsa", "dpgd", "deepca"])
def test_baseline_ragged_sweep_matches_unpadded_runs(cov_cases, name):
    cc = cov_cases
    sw = ts.baseline_sweep(name, covs=cc["covs"], engines=cc["engines"], r=4,
                           t_outer=8, seeds=SEEDS[:2], q_true=cc["q_true"])
    assert sw.error_traces.shape == (2, 2, 8)
    np.testing.assert_array_equal(sw.node_counts, [6, 10])
    for ci, (eng, cv) in enumerate(zip(cc["engines"], cc["covs"])):
        for si, s in enumerate(SEEDS[:2]):
            q1, errs = getattr(tb, name)(cv, eng, 4, 8, q_true=cc["q_true"],
                                         seed=s, device="cpu")
            close(sw.error_traces[ci, si], errs, LANE_ATOL)
            # padded nodes stay isolated: the real nodes' estimates match
            close(sw.q[ci, si, :eng.graph.n_nodes], q1, LANE_ATOL)


def test_baseline_single_engine_list_squeezes(cov_cases):
    cc = cov_cases
    sw = ts.baseline_sweep("dsa", covs=[cc["covs"][0]],
                           engines=[cc["engines"][0]], r=4, t_outer=5,
                           seeds=SEEDS[:2], q_true=cc["q_true"])
    assert sw.error_traces.shape == (2, 5)          # no case axis
    assert sw.node_counts is None
    ref = ts.baseline_sweep("dsa", covs=cc["covs"][0],
                            engine=cc["engines"][0], r=4, t_outer=5,
                            seeds=SEEDS[:2], q_true=cc["q_true"])
    np.testing.assert_array_equal(sw.error_traces, ref.error_traces)


def test_baseline_ragged_rejections(cov_cases):
    cc = cov_cases
    with pytest.raises(ValueError, match="not both"):
        ts.baseline_sweep("dsa", covs=cc["covs"], engine=cc["engines"][0],
                          engines=cc["engines"], r=4, t_outer=3, seeds=[0])
    with pytest.raises(ValueError, match="single-case"):
        ts.baseline_sweep("seq_dist_pm", covs=cc["covs"],
                          engines=cc["engines"], r=4, iters_per_vec=3,
                          seeds=[0])
    with pytest.raises(ValueError, match="node count"):
        ts.baseline_sweep("dsa", covs=[cc["covs"][0], cc["covs"][0]],
                          engines=cc["engines"], r=4, t_outer=3, seeds=[0])


# ---------------------------------------------------------------------------
# refusals and conventions
# ---------------------------------------------------------------------------
def test_sweep_without_q_true_has_no_traces(prob):
    sw = ts.sdot_sweep(covs=prob["t_covs"], engines=tengine(10, "er"),
                       r=prob["r"], t_outer=5, t_c=10, seeds=[0, 1])
    assert sw.error_traces is None
    with pytest.raises(ValueError, match="q_true"):
        sw.mean_trace


@pytest.mark.parametrize("case", ["zip", "node_count", "sparse"])
def test_sweep_rejections(prob, case):
    kw = dict(covs=prob["t_covs"], r=prob["r"], t_outer=5, seeds=[0])
    if case == "zip":
        with pytest.raises(ValueError, match="zip-broadcast"):
            ts.sdot_sweep(engines=[tengine(10, "er"), tengine(10, "ring")],
                          schedules=[consensus_schedule("const", 5,
                                                        t_max=10)] * 3, **kw)
    elif case == "node_count":
        with pytest.raises(ValueError, match="node count"):
            ts.sdot_sweep(engines=[tengine(10, "er"), tengine(7, "ring")],
                          **kw)
    else:
        with pytest.raises(ValueError, match="dense engines"):
            ts.sdot_sweep(engines=tengine(10, "er", sparse=True), **kw)


def test_merge_shards_concatenates_and_refuses(prob):
    engines = [tengine(10, "er"), tengine(10, "ring")]
    kw = dict(covs=prob["t_covs"], engines=engines, r=prob["r"], t_outer=4,
              t_c=10, q_true=prob["t_q_true"])
    full = ts.sdot_sweep(seeds=[0, 1, 2], **kw)
    trees = []
    for shard in ts.slice_seed_shards([0, 1, 2], 2):
        sw = ts.sdot_sweep(seeds=shard, **kw)
        trees.append(dict(q=sw.q.numpy(), seeds=sw.seeds, ledger=sw.ledger,
                          error_traces=sw.error_traces, spec_fp=7))
    merged = ts.SweepResult.merge_shards(trees, n_cases=2, has_err=True,
                                         ragged=False)
    np.testing.assert_array_equal(merged.error_traces, full.error_traces)
    assert torch.equal(merged.q, full.q)
    np.testing.assert_array_equal(merged.seeds, [0, 1, 2])
    assert_ledgers_equal(merged.ledger, full.ledger)
    with pytest.raises(ValueError, match="different sweep specs"):
        ts.SweepResult.merge_shards([trees[0], dict(trees[1], spec_fp=8)],
                                    n_cases=2, has_err=True, ragged=False)
    with pytest.raises(ValueError, match="overlapping seed"):
        ts.SweepResult.merge_shards([trees[0], trees[0]], n_cases=2,
                                    has_err=True, ragged=False)


# ---------------------------------------------------------------------------
# network-fault sweeps
# ---------------------------------------------------------------------------
def _fault_engines(n=10, seed=7):
    graph = ttopo.erdos_renyi(n, 0.5, seed=1)
    model = lambda p: NetFaultModel(  # noqa: E731
        p_drop=p, p_bad=0.05, p_good=0.5, crash_windows=((0, 2, 2),))
    return graph, [FaultyConsensus(graph, model(p), seed=seed, device="cpu")
                   for p in (0.1, 0.2)]


def test_netfault_sweep_lanes_match_per_seed_runs(prob):
    """Lane (c, s) is the single faulty run of
    ``FaultyConsensus(seed=netfault_lane_seed(engine seed, s))``."""
    graph, engines = _fault_engines()
    seeds = [0, 1, 2, 3]
    sw = ts.netfault_sweep(covs=prob["t_covs"], engines=engines, r=prob["r"],
                           t_outer=6, t_c=10, seeds=seeds,
                           q_true=prob["t_q_true"])
    led = CommLedger()
    for ci, eng in enumerate(engines):
        for si, s in enumerate(seeds):
            lane_eng = FaultyConsensus(graph, eng.faults, device="cpu",
                                       seed=ts.netfault_lane_seed(7, s))
            res = sdot(covs=prob["t_covs"], engine=lane_eng, r=prob["r"],
                       t_outer=6, t_c=10, generator=gen(s),
                       q_true=prob["t_q_true"], device="cpu")
            led = led.merged(res.ledger)
            close(sw.error_traces[ci, si], res.error_trace, LANE_ATOL)
            close(sw.q[ci, si], res.q_nodes, LANE_ATOL)
    assert_ledgers_equal(sw.ledger, led)


def test_netfault_sweep_shard_is_independent_of_the_grid(prob):
    _, engines = _fault_engines()
    kw = dict(covs=prob["t_covs"], engines=engines, r=prob["r"], t_outer=5,
              t_c=8, q_true=prob["t_q_true"])
    full = ts.netfault_sweep(seeds=[0, 1, 2, 3], **kw)
    shard = ts.netfault_sweep(seeds=[2, 3], **kw)
    np.testing.assert_array_equal(shard.error_traces,
                                  full.error_traces[:, 2:])
    assert torch.equal(shard.q, full.q[:, 2:])


def test_netfault_sweep_rejections(prob):
    _, engines = _fault_engines()
    kw = dict(covs=prob["t_covs"], r=prob["r"], t_outer=3, seeds=[0])
    with pytest.raises(ValueError, match="FaultyConsensus"):
        ts.netfault_sweep(engines=[tengine(10, "er")], **kw)
    nominal = FaultyConsensus(engines[0].graph, engines[0].faults,
                              debias="nominal", device="cpu")
    with pytest.raises(ValueError, match="debias"):
        ts.netfault_sweep(engines=[engines[0], nominal], **kw)


# ---------------------------------------------------------------------------
# chunked sweeps: killed and resumed mid-grid, the uninterrupted bits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["sdot_data", "fdot", "deepca",
                                    "netfault"])
def test_chunked_sweep_resumes_bitwise(tmp_path, prob, fprob, family):
    if family == "sdot_data":
        run = lambda **kw: ts.sdot_sweep(  # noqa: E731
            data=prob["t_blocks"],
            engines=[tengine(10, "er"), tengine(10, "ring")],
            schedules=[consensus_schedule("const", 9, t_max=20),
                       consensus_schedule("lin2", 9, cap=20)],
            r=prob["r"], t_outer=9, seeds=[0, 1], q_true=prob["t_q_true"],
            **kw)
    elif family == "fdot":
        run = lambda **kw: ts.fdot_sweep(  # noqa: E731
            data_blocks=fprob["t_blocks"], engines=tengine(10, "er"), r=5,
            t_outer=9, t_c=20, seeds=[0, 1], q_true=fprob["t_q_true"], **kw)
    elif family == "deepca":
        run = lambda **kw: ts.baseline_sweep(  # noqa: E731
            "deepca", covs=prob["t_covs"], engine=tengine(10, "er"),
            r=prob["r"], t_outer=9, seeds=[0, 1], q_true=prob["t_q_true"],
            **kw)
    else:
        run = lambda **kw: ts.netfault_sweep(  # noqa: E731
            covs=prob["t_covs"], engines=_fault_engines()[1], r=prob["r"],
            t_outer=9, t_c=8, seeds=[0, 1], q_true=prob["t_q_true"], **kw)
    full = run()
    killed = run(manager=CheckpointManager(str(tmp_path)), chunk_size=2,
                 max_chunks=2)
    assert killed.steps_done == 4
    res = run(manager=CheckpointManager(str(tmp_path)), chunk_size=2)
    assert res.resumed_step == 4 and res.steps_done == 9
    np.testing.assert_array_equal(res.error_traces, full.error_traces)
    assert torch.equal(res.q, full.q)
    assert_ledgers_equal(res.ledger, full.ledger)
