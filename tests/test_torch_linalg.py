"""Port vs reference: CholeskyQR2, eigh_topr, orthogonal iteration, and the
port's own orthonormal_init (CPU). Subspaces are compared, not signs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.linalg import cholesky_qr2 as j_cqr2, eigh_topr as j_eigh
from repro.core.metrics import subspace_error as j_subspace_error
from repro.core.oi import oi_trace as j_oi_trace
from repro.core.oi import orthogonal_iteration as j_oi
from repro_torch.core.linalg import (cholesky_qr2, eigh_topr,
                                     orthonormal_init)
from repro_torch.core.metrics import subspace_error
from repro_torch.core.oi import oi_trace, orthogonal_iteration

TOL = 1e-5   # f32 CholeskyQR2 on both sides; only the op order differs


def _sym(rng, d):
    a = rng.standard_normal((d, d))
    return (a @ a.T / d).astype(np.float32)


@pytest.mark.parametrize("shape", [(20, 5), (64, 8), (3, 12, 4)])
def test_cholesky_qr2_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    v = rng.standard_normal(shape).astype(np.float32)
    q, r = cholesky_qr2(torch.from_numpy(v))
    eye = torch.eye(shape[-1]).expand(*q.shape[:-2], -1, -1)
    torch.testing.assert_close(q.mT @ q, eye, atol=TOL, rtol=0)
    torch.testing.assert_close(q @ r, torch.from_numpy(v), atol=1e-4,
                               rtol=1e-4)
    vs = v.reshape(-1, *shape[-2:])
    for i in range(vs.shape[0]):
        qj, rj = j_cqr2(jnp.asarray(vs[i]))
        np.testing.assert_allclose(q.reshape(-1, *shape[-2:])[i].numpy(),
                                   np.asarray(qj), atol=TOL, rtol=0)
        np.testing.assert_allclose(r.reshape(-1, *shape[-1:] * 2)[i].numpy(),
                                   np.asarray(rj), atol=1e-4, rtol=1e-5)


def test_eigh_topr_matches_reference():
    rng = np.random.default_rng(1)
    m = _sym(rng, 24)
    vals, vecs = eigh_topr(torch.from_numpy(m), 5)
    jvals, jvecs = j_eigh(jnp.asarray(m), 5)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=TOL,
                               atol=TOL)
    assert float(subspace_error(torch.tensor(np.asarray(jvecs)),
                                vecs)) <= TOL


def test_orthogonal_iteration_matches_reference():
    rng = np.random.default_rng(2)
    m = _sym(rng, 20)
    q0 = np.linalg.qr(rng.standard_normal((20, 4)))[0].astype(np.float32)
    q = orthogonal_iteration(torch.from_numpy(m), torch.from_numpy(q0), 30)
    qj = j_oi(jnp.asarray(m), jnp.asarray(q0), 30)
    assert float(subspace_error(torch.tensor(np.asarray(qj)), q)) <= TOL


@pytest.mark.parametrize("with_metric", [True, False])
def test_oi_trace_matches_reference(with_metric):
    """q within TOL (the baselines' 1e-5) of the reference's subspace, and
    the trace of the subspace error against the top-r eigenvectors (or the
    zeros without a metric) within TOL of the reference's, iteration by
    iteration."""
    rng = np.random.default_rng(3)
    m = _sym(rng, 24)
    q0 = np.linalg.qr(rng.standard_normal((24, 5)))[0].astype(np.float32)
    q_true = np.linalg.eigh(m.astype(np.float64))[1][:, -5:].astype(
        np.float32)
    qt = torch.from_numpy(q_true)
    q, trace = oi_trace(torch.from_numpy(m), torch.from_numpy(q0), 25,
                        (lambda q: subspace_error(qt, q)) if with_metric
                        else None)
    qj, tj = j_oi_trace(jnp.asarray(m), jnp.asarray(q0), 25,
                        (lambda q: j_subspace_error(jnp.asarray(q_true), q))
                        if with_metric else None)
    assert trace.shape == np.asarray(tj).shape == (25,)
    assert float(subspace_error(torch.tensor(np.asarray(qj)), q)) <= TOL
    np.testing.assert_allclose(trace.numpy(), np.asarray(tj), atol=TOL,
                               rtol=0)
    if with_metric:
        assert trace[-1] < trace[0]
    q0_only, empty = oi_trace(torch.from_numpy(m), torch.from_numpy(q0), 0)
    assert empty.shape == (0,) and torch.equal(q0_only, torch.from_numpy(q0))


def test_orthonormal_init_with_generator_is_orthonormal_and_seeded():
    q = orthonormal_init(torch.Generator().manual_seed(7), 30, 6)
    assert q.shape == (30, 6) and q.dtype == torch.float32
    torch.testing.assert_close(q.T @ q, torch.eye(6), atol=1e-6, rtol=0)
    again = orthonormal_init(torch.Generator().manual_seed(7), 30, 6)
    torch.testing.assert_close(q, again, atol=0, rtol=0)
