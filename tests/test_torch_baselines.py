"""The port's baselines (``repro_torch.core.baselines``) against the JAX
reference on the CPU: twins of ``tests/test_baselines.py`` and of the
baseline cases of ``tests/test_fused_zoo.py``.

Both packages get the same NumPy covs, graph and ground truth, and the
port starts from the reference's own init (``orthonormal_init`` of
``PRNGKey(seed)``, passed as ``q_init``). Tolerances:

* port fused against port eager: TRACE_ATOL / Q_ATOL, the reference's own
  fused-vs-eager rtol 1e-4 / atol 1e-6 on the trace and 1e-5 on q (the
  eager loop debiases by the host matrix power, the fused one by the
  device table);
* port against reference: the same, f32 on both sides with products
  summed in other orders;
* a chunked run killed and resumed against the uninterrupted one: bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import consensus as jc
from repro.core import topology as jtopo
from repro.core.linalg import orthonormal_init as j_init
from repro.core.metrics import CommLedger as JLedger
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import baselines as tb
from repro_torch.core import topology as ttopo
from repro_torch.core.async_gossip import AsyncConsensus
from repro_torch.core.consensus import DenseConsensus
from repro_torch.core.metrics import CommLedger
from repro_torch.core.sdot import sdot
from repro_torch.streaming.resume import baseline_chunked

TRACE_RTOL, TRACE_ATOL = 1e-4, 1e-6
Q_RTOL, Q_ATOL = 1e-4, 1e-5
LEDGER_FIELDS = ("p2p", "matrices", "scalars", "payload_bytes")

KW = {"dsa": dict(t_outer=40, lr=0.05), "dpgd": dict(t_outer=40, lr=0.05),
      "deepca": dict(t_outer=30, t_mix=3),
      "seq_dist_pm": dict(iters_per_vec=8, t_c=50)}


def t32(a):
    return torch.tensor(np.asarray(a, np.float32))


def ref_init(seed, d, r):
    return np.asarray(j_init(jax.random.PRNGKey(seed), d, r))


@pytest.fixture(scope="module")
def prob(psa_problem):
    p = psa_problem
    d, r = p["d"], p["r"]
    return dict(d=d, r=r, n=p["n_nodes"], covs=p["covs"], q_true=p["q_true"],
                t_covs=t32(p["covs"]), t_q_true=t32(p["q_true"]),
                t_m=t32(p["m"]), m=p["m"], q_init=t32(ref_init(0, d, r)))


@pytest.fixture(scope="module")
def feature_prob(prob):
    from repro.data.pipeline import gaussian_eigengap_data, partition_features
    from repro.core.linalg import eigh_topr
    x, _, _ = gaussian_eigengap_data(20, 3000, 5, 0.7, seed=0)
    _, q_true = eigh_topr(x @ x.T, 5)
    blocks = partition_features(x, 10)
    return dict(blocks=blocks, t_blocks=[t32(b) for b in blocks],
                q_true=q_true[:, :3], t_q_true=t32(q_true[:, :3]),
                q_init=t32(ref_init(0, 20, 3)))


def engines(n, topo):
    if topo == "er":
        return (jc.DenseConsensus(jtopo.erdos_renyi(n, 0.5, seed=1)),
                DenseConsensus(ttopo.erdos_renyi(n, 0.5, seed=1),
                               device="cpu"))
    return (jc.DenseConsensus(jtopo.ring(n)),
            DenseConsensus(ttopo.ring(n), device="cpu"))


def assert_ledgers_equal(a, b):
    for f in LEDGER_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def assert_trace_close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=TRACE_RTOL,
                               atol=TRACE_ATOL)


def assert_q_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=Q_RTOL, atol=Q_ATOL)


# ---------------------------------------------------------------------------
# fused against eager, and against the reference (ledgers included)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topo", ["er", "ring"])
@pytest.mark.parametrize("name", ["dsa", "dpgd", "deepca", "seq_dist_pm"])
def test_baseline_fused_matches_eager_and_reference(prob, topo, name):
    j_eng, t_eng = engines(prob["n"], topo)
    kw = KW[name]
    j_led = JLedger()
    q_ref, e_ref = getattr(jb, name)(prob["covs"], j_eng, prob["r"],
                                     q_true=prob["q_true"], ledger=j_led,
                                     **kw)
    fn = getattr(tb, name)
    led_e, led_f = CommLedger(), CommLedger()
    q_e, e_e = fn(prob["t_covs"], t_eng, prob["r"], q_true=prob["t_q_true"],
                  ledger=led_e, fused=False, q_init=prob["q_init"],
                  device="cpu", **kw)
    q_f, e_f = fn(prob["t_covs"], t_eng, prob["r"], q_true=prob["t_q_true"],
                  ledger=led_f, fused=True, q_init=prob["q_init"],
                  device="cpu", **kw)
    assert_trace_close(e_f, e_e)
    assert_q_close(q_f, q_e)
    assert_ledgers_equal(led_f, led_e)
    assert_trace_close(e_f, e_ref)
    assert_q_close(q_f, q_ref)
    assert_ledgers_equal(led_f, j_led)


@pytest.mark.parametrize("topo", ["er", "ring"])
def test_d_pm_fused_matches_eager_and_reference(feature_prob, topo):
    fp = feature_prob
    j_eng, t_eng = engines(10, topo)
    j_led = JLedger()
    q_ref, e_ref = jb.d_pm(fp["blocks"], j_eng, 3, iters_per_vec=10, t_c=50,
                           q_true=fp["q_true"], ledger=j_led)
    led_e, led_f = CommLedger(), CommLedger()
    kw = dict(iters_per_vec=10, t_c=50, q_true=fp["t_q_true"],
              q_init=fp["q_init"], device="cpu")
    q_e, e_e = tb.d_pm(fp["t_blocks"], t_eng, 3, ledger=led_e, fused=False,
                       **kw)
    q_f, e_f = tb.d_pm(fp["t_blocks"], t_eng, 3, ledger=led_f, fused=True,
                       **kw)
    assert_trace_close(e_f, e_e)
    assert_q_close(q_f, q_e)
    assert_ledgers_equal(led_f, led_e)
    assert_trace_close(e_f, e_ref)
    assert_q_close(q_f, q_ref)
    assert_ledgers_equal(led_f, j_led)


def test_seq_pm_matches_reference(prob):
    q_ref, e_ref = jb.seq_pm(prob["m"], prob["r"], iters_per_vec=60,
                             q_true=prob["q_true"])
    q, errs = tb.seq_pm(prob["t_m"], prob["r"], iters_per_vec=60,
                        q_true=prob["t_q_true"], q_init=prob["q_init"],
                        device="cpu")
    assert_trace_close(errs, e_ref)
    assert_q_close(q, q_ref)


# ---------------------------------------------------------------------------
# the reference's claims (tests/test_baselines.py), on the port
# ---------------------------------------------------------------------------
def test_seq_pm_converges_with_a_sequential_plateau(prob):
    _, errs = tb.seq_pm(prob["t_m"], prob["r"], iters_per_vec=60,
                        q_true=prob["t_q_true"], device="cpu")
    assert errs[-1] < 1e-4
    assert errs[len(errs) // prob["r"] - 1] > errs[-1] * 10


@pytest.mark.parametrize("name,kw,limit", [
    ("seq_dist_pm", dict(iters_per_vec=60, t_c=50), 1e-3),
    ("dsa", dict(t_outer=300, lr=0.05), 0.1),
    ("dpgd", dict(t_outer=300, lr=0.05), 0.2),
    ("deepca", dict(t_outer=150, t_mix=3), 1e-4),
])
def test_baseline_reaches_its_limit(prob, name, kw, limit):
    _, t_eng = engines(prob["n"], "er")
    _, errs = getattr(tb, name)(prob["t_covs"], t_eng, prob["r"],
                                q_true=prob["t_q_true"], device="cpu", **kw)
    assert errs[-1] < limit
    assert errs[-1] < errs[0]


def test_sdot_beats_neighborhood_methods(prob):
    """Paper Fig. 4: S-DOT's floor is orders below DSA's and DPGD's."""
    _, t_eng = engines(prob["n"], "er")
    res = sdot(covs=prob["t_covs"], engine=t_eng, r=prob["r"], t_outer=100,
               t_c=50, q_true=prob["t_q_true"], device="cpu")
    for fn in (tb.dsa, tb.dpgd):
        _, errs = fn(prob["t_covs"], t_eng, prob["r"], t_outer=300, lr=0.05,
                     q_true=prob["t_q_true"], device="cpu")
        assert res.error_trace[-1] < errs[-1] / 100


def test_d_pm_feature_partitioned():
    from repro_torch.data.pipeline import (gaussian_eigengap_data,
                                           partition_features)
    x, _, _ = gaussian_eigengap_data(10, 2000, 3, 0.5, seed=7, device="cpu")
    q_true = torch.linalg.eigh((x @ x.T).double())[1][:, -3:].float()
    eng = DenseConsensus(ttopo.erdos_renyi(10, 0.5, seed=8), device="cpu")
    _, errs = tb.d_pm(partition_features(x, 10), eng, 3, iters_per_vec=80,
                      t_c=60, q_true=q_true, device="cpu")
    assert errs[-1] < 1e-3


# ---------------------------------------------------------------------------
# conventions: NaN traces, async engines, the program's refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [True, False])
def test_no_q_true_gives_a_nan_trace(prob, fused):
    _, t_eng = engines(prob["n"], "er")
    _, errs = tb.dsa(prob["t_covs"], t_eng, prob["r"], t_outer=5,
                     fused=fused, device="cpu")
    assert errs.shape == (5,)
    assert np.all(np.isnan(errs))


@pytest.mark.parametrize("name", ["seq_dist_pm", "d_pm"])
def test_async_engine_logs_realized_sends(prob, feature_prob, name):
    """With an async engine the eager loop logs the realized sends of every
    call (awake-dependent), not the synchronous closed form."""
    eng = AsyncConsensus(ttopo.erdos_renyi(10, 0.5, seed=1), p_awake=0.5,
                         seed=0, device="cpu")
    led = CommLedger()
    if name == "seq_dist_pm":
        tb.seq_dist_pm(prob["t_covs"], eng, 2, iters_per_vec=2, t_c=10,
                       ledger=led, device="cpu")
    else:
        tb.d_pm(feature_prob["t_blocks"], eng, 2, iters_per_vec=2, t_c=10,
                ledger=led, device="cpu")
    rounds = 2 * 2 * 10
    assert len(led.awake_counts) == rounds
    sync_sends = float(eng.graph.adjacency.sum()) * rounds
    assert 0 < led.p2p < sync_sends          # ~p_awake^2 of the sync count


def test_baseline_program_refusals(prob):
    eng = AsyncConsensus(ttopo.erdos_renyi(10, 0.5, seed=1), p_awake=0.5,
                         device="cpu")
    with pytest.raises(ValueError, match="debias table"):
        tb.baseline_program("dsa", covs=prob["t_covs"], engine=eng, r=2,
                            t_outer=3, device="cpu")
    _, t_eng = engines(prob["n"], "er")
    with pytest.raises(ValueError, match="unknown baseline"):
        tb.baseline_program("oja", covs=prob["t_covs"], engine=t_eng, r=2,
                            t_outer=3, device="cpu")
    with pytest.raises(ValueError, match="needs covs and t_outer"):
        tb.baseline_program("dpgd", engine=t_eng, r=2, device="cpu")


# ---------------------------------------------------------------------------
# chunked, killed and resumed: the uninterrupted run's bits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["dsa", "dpgd", "deepca", "seq_dist_pm",
                                  "d_pm"])
def test_baseline_chunked_resume_bitwise(tmp_path, prob, feature_prob,
                                         name):
    _, t_eng = engines(prob["n"], "er")
    if name == "d_pm":
        kw = dict(data_blocks=feature_prob["t_blocks"], r=3,
                  iters_per_vec=4, t_c=20, q_true=feature_prob["t_q_true"])
    else:
        kw = dict(covs=prob["t_covs"], r=prob["r"], q_true=prob["t_q_true"],
                  **({"iters_per_vec": 3, "t_c": 20} if name == "seq_dist_pm"
                     else {"t_outer": 14}))
    full = baseline_chunked(name, engine=t_eng, chunk_size=100,
                            device="cpu", **kw)
    baseline_chunked(name, engine=t_eng, chunk_size=4, max_chunks=2,
                     manager=CheckpointManager(str(tmp_path)), device="cpu",
                     **kw)
    res = baseline_chunked(name, engine=t_eng, chunk_size=4,
                           manager=CheckpointManager(str(tmp_path)),
                           device="cpu", **kw)
    np.testing.assert_array_equal(res.error_trace, full.error_trace)
    assert torch.equal(res.q, full.q)
    assert_ledgers_equal(res.ledger, full.ledger)
    fused = getattr(tb, name)
    args = ((kw.pop("data_blocks"),) if name == "d_pm"
            else (kw.pop("covs"),))
    q, errs = fused(*args, t_eng, kw.pop("r"), device="cpu", **kw)
    np.testing.assert_array_equal(errs, full.error_trace)
