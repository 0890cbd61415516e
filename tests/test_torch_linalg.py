"""Port vs reference: CholeskyQR2, eigh_topr, orthogonal iteration, and the
port's own orthonormal_init (CPU). Subspaces are compared, not signs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.linalg import cholesky_qr2 as j_cqr2, eigh_topr as j_eigh
from repro.core.oi import orthogonal_iteration as j_oi
from repro_torch.core.linalg import (cholesky_qr2, eigh_topr,
                                     orthonormal_init)
from repro_torch.core.metrics import subspace_error
from repro_torch.core.oi import orthogonal_iteration

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


def test_orthonormal_init_with_generator_is_orthonormal_and_seeded():
    q = orthonormal_init(torch.Generator().manual_seed(7), 30, 6)
    assert q.shape == (30, 6) and q.dtype == torch.float32
    torch.testing.assert_close(q.T @ q, torch.eye(6), atol=1e-6, rtol=0)
    again = orthonormal_init(torch.Generator().manual_seed(7), 30, 6)
    torch.testing.assert_close(q, again, atol=0, rtol=0)
