"""Hypothesis sweep of the CholeskyQR Gram: the port's plain version
against the reference's Pallas kernel in interpret mode (CPU). Kept apart
from tests/test_torch_gram_qr.py, as the reference keeps its own sweeps, so
the deterministic tests run where ``hypothesis`` is not installed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# the same input bits, f32 sums on both sides: 1e-4 of max|G| for both dtypes
# (why not the reference's bf16 limit: tests/test_torch_gram_qr.py)
GRAM_REL = 1e-4


@settings(max_examples=12, deadline=None)
@given(d=st.integers(10, 3000), r=st.sampled_from([2, 8, 64]),
       dtype=st.sampled_from(["float32", "bfloat16"]),
       seed=st.integers(0, 1000))
def test_gram_qr_ref_matches_pallas_property(d, r, dtype, seed):
    v = np.random.default_rng(seed).standard_normal((d, r)).astype(np.float32)
    want = jops.gram_qr(jnp.asarray(v).astype(dtype), block_d=512,
                        use_pallas=True)
    got = ops.gram_qr(torch.from_numpy(v).to(getattr(torch, dtype)))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAM_REL * np.abs(want).max())
