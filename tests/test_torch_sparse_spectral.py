"""The port's spectral helpers on a ``SparseW`` and its subspace metrics
``principal_angles`` / ``projector_distance``, held against the JAX
reference on the same NumPy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.core import sparse as jsparse
from repro.core import topology as jtopo
from repro_torch.core import metrics as tmetrics
from repro_torch.core import sparse as tsparse
from repro_torch.core import topology as ttopo

# watts_strogatz(1000, 6, 0.1, seed=1), local-degree weights: the
# reference's gap and mixing time (power iteration, contraction bound)
WS_GAP, WS_MIX = 0.0265176, 26


@pytest.fixture(scope="module")
def ws1000():
    g = ttopo.watts_strogatz(1000, k=6, p=0.1, seed=1)
    w = ttopo.local_degree_weights(g)
    return (g, w, tsparse.SparseW.from_dense(w, g.adjacency, device="cpu"),
            jsparse.SparseW.from_dense(w, g.adjacency))


def test_sparse_spectral_gap_and_mixing_time_match_reference(ws1000):
    _, _, sw, jsw = ws1000
    gap = ttopo.spectral_gap(sw)
    want = jtopo.spectral_gap(jsw)
    assert abs(gap - WS_GAP) <= 1e-4 * WS_GAP
    assert abs(gap - want) <= 1e-4 * want
    assert ttopo.mixing_time(sw) == jtopo.mixing_time(jsw) == WS_MIX


def test_sparsew_spectral_gap_method_matches_function(ws1000):
    _, _, sw, _ = ws1000
    assert sw.spectral_gap() == ttopo.spectral_gap(sw)


def test_exact_spectral_gap_rejects_sparsew(ws1000):
    with pytest.raises(ValueError, match="dense"):
        ttopo.spectral_gap(ws1000[2], method="exact")


@pytest.mark.parametrize("cols", [None, 3])
def test_mix_host_matches_dense_product(ws1000, cols):
    _, w, sw, jsw = ws1000
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000 if cols is None else (1000, cols))
    got = sw.mix_host(x)
    np.testing.assert_allclose(got, w @ x, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, jsw.mix_host(x), rtol=1e-12, atol=1e-12)


def _orthonormal_pair(d, r, seed):
    rng = np.random.default_rng(seed)
    return [np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("d,r,seed", [(20, 3, 6), (10, 3, 8), (64, 7, 1)])
def test_principal_angles_and_projector_distance_match_reference(d, r, seed):
    a, b = _orthonormal_pair(d, r, seed)
    th = tmetrics.principal_angles(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(
        th.numpy(), np.asarray(jmetrics.principal_angles(jnp.asarray(a),
                                                         jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)
    pd = tmetrics.projector_distance(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(
        float(pd), float(jmetrics.projector_distance(jnp.asarray(a),
                                                     jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)


def test_projector_distance_vs_subspace_error():
    """||PP - QQ||_2 = sin(theta_max); E = mean sin^2: consistent ordering
    (the twin of the reference's test)."""
    q1, q2 = (torch.from_numpy(q) for q in _orthonormal_pair(20, 3, 6))
    pd = float(tmetrics.projector_distance(q1, q2))
    se = float(tmetrics.subspace_error(q1, q2))
    assert 0 <= se <= pd ** 2 + 1e-6


def test_principal_angles_range():
    q1, q2 = (torch.from_numpy(q) for q in _orthonormal_pair(10, 3, 8))
    th = tmetrics.principal_angles(q1, q2).numpy()
    assert np.all(th >= -1e-7) and np.all(th <= np.pi / 2 + 1e-6)
