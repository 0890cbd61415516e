"""The CholeskyQR Gram G = V^T V: the port's plain version (what
``ops.gram_qr`` runs on the CPU) against the reference's Pallas kernel in
interpret mode, its batched form against per-matrix reference calls, and
the port's CholeskyQR passes routed through ``ops.gram_qr`` (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import fdot as tfdot
from repro_torch.core.linalg import cholesky_qr, cholesky_qr2
from repro_torch.kernels import ops, ref

# the reference's own kernel-vs-oracle tolerances (tests/test_kernels.py,
# tests/test_kernels_property.py): f32 sums over row blocks in another order
ALIGNED_RTOL, ALIGNED_ATOL = 1e-4, 1e-3
# Both sides get the same input bits (bf16 too) and sum in f32, so they
# differ only by the order of f32 sums: hold every element to 1e-4 of
# max|G| for f32 and bf16 alike. The reference's bf16 limit (atol 0.02 d)
# is as large as a typical off-diagonal of G, because it compares with an
# oracle fed other bits; a Gram summed in bf16 would pass it, not this.
GRAM_REL = 1e-4


def assert_gram_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=GRAM_REL * np.abs(want).max())


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(v: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array (bf16: both round the f32
    values to nearest even, so the bits agree)."""
    return (jnp.asarray(v).astype(dtype),
            torch.from_numpy(v).to(getattr(torch, dtype)))


@pytest.mark.parametrize("d,r", [(1536, 8), (2048, 16)])
def test_gram_qr_ref_matches_pallas_kernel(d, r):
    v = _normal((d, r), d + r)
    want = jops.gram_qr(jnp.asarray(v), block_d=512, use_pallas=True)
    got = ref.gram_qr_ref(torch.from_numpy(v))
    assert got.dtype == torch.float32 and got.shape == (r, r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ALIGNED_RTOL, atol=ALIGNED_ATOL)


def test_gram_qr_ref_symmetric_psd():
    g = ref.gram_qr_ref(torch.from_numpy(_normal((2048, 16), 1))).numpy()
    np.testing.assert_allclose(g, g.T, rtol=1e-6)
    assert np.linalg.eigvalsh(g).min() > -1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_gram_qr_matches_per_matrix_reference(dtype):
    """One call over a (3, 2, d, r) batch against a reference call per
    matrix, ragged d (not a multiple of the 512-row block)."""
    v = _normal((3, 2, 1300, 7), 5)
    jv, tv = _pair(v, dtype)
    got = ops.gram_qr(tv)
    assert got.shape == (3, 2, 7, 7) and got.dtype == torch.float32
    for i in range(3):
        for j in range(2):
            want = jops.gram_qr(jv[i, j], block_d=512, use_pallas=True)
            assert_gram_close(got[i, j].numpy(), want)


def test_gram_qr_on_cpu_launches_nothing():
    ops.reset_launches()
    ops.gram_qr(torch.ones((40, 3)))
    assert ops.LAUNCHES["gram_qr"] == 0


def test_cholesky_passes_route_their_gram_through_ops(monkeypatch):
    """CholeskyQR2 (S-DOT step 12) takes two Grams through ops.gram_qr, one
    per pass over the whole node batch; F-DOT's in-loop distributed QR pass
    takes one over the (N, d_max, r) slabs. Each value equals the plain
    product."""
    calls = []

    def spy(v):
        calls.append(tuple(v.shape))
        return ref.gram_qr_ref(v)

    monkeypatch.setattr(ops, "gram_qr", spy)
    v = torch.from_numpy(_normal((4, 30, 5), 2))
    cholesky_qr2(v)
    assert calls == [(4, 30, 5), (4, 30, 5)]
    _, r1 = cholesky_qr(v)
    torch.testing.assert_close(r1.mT @ r1, v.mT @ v, rtol=1e-5, atol=1e-4)

    calls.clear()
    w = torch.full((4, 4), 0.25)
    table = torch.ones((3, 4))
    tfdot._qr_pass(w, table, v, 2, 2)
    assert calls == [(4, 30, 5)]
