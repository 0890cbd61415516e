"""Port kernels vs the reference: the plain versions against
``repro.kernels.ref`` and the interpret-mode Pallas kernels, the CPU
dispatch of ``repro_torch.kernels.ops`` (CPU). The Hopper kernels against
their plain versions are in ``test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jtopo
from repro.core.sparse import SparseW as JSparseW
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

# f32 sums in another order than the reference (XLA CPU / Pallas interpret)
RTOL, ATOL = 1e-4, 1e-5


def _ragged_stack(rng, n_true, d):
    x = np.zeros((len(n_true), d, int(max(n_true))), np.float32)
    for i, ni in enumerate(n_true):
        x[i, :, :ni] = rng.standard_normal((d, ni))
    return x


# ---------------------------------------------------------------------------
# gram-apply (rows 1-2 of the kernel table)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_true", [[300, 150, 512, 77], [14, 14, 14], [5, 3]],
                         ids=["ragged", "sparse-phase", "below-tile"])
def test_batched_gram_apply_matches_reference_and_pallas(n_true):
    rng = np.random.default_rng(len(n_true))
    d, r = 32, 5
    x = _ragged_stack(rng, n_true, d)
    q = rng.standard_normal((len(n_true), d, r)).astype(np.float32)
    nt = np.asarray(n_true, np.float32)
    got = ops.batched_gram_apply(torch.from_numpy(x), torch.from_numpy(q),
                                 torch.from_numpy(nt)).numpy()
    want_ref = np.asarray(jref.batched_gram_apply_ref(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(nt)))
    want_pallas = np.asarray(jops.batched_gram_apply(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(nt), block_n=256,
        use_pallas=True, interpret=True))
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [513, 40])
def test_gram_apply_matches_reference_and_pallas(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((32, n)).astype(np.float32)
    q = rng.standard_normal((32, 8)).astype(np.float32)
    got = ops.gram_apply(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    want_ref = np.asarray(jref.gram_apply_ref(jnp.asarray(x), jnp.asarray(q)))
    want_pallas = np.asarray(jops.gram_apply(jnp.asarray(x), jnp.asarray(q),
                                             block_n=256, use_pallas=True))
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# ELL gossip round (row 3 of the kernel table)
# ---------------------------------------------------------------------------
def _ell(n, seed=0, kind="ws"):
    g = (jtopo.watts_strogatz(n, k=4, p=0.2, seed=seed) if kind == "ws"
         else jtopo.barabasi_albert(n, m=3, seed=seed))
    sw = JSparseW.from_graph(g)
    return (np.asarray(sw.ell_idx), np.asarray(sw.ell_val),
            np.asarray(sw.diag))


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("payload", [None, "bfloat16"])
def test_ell_spmm_plain_matches_reference_and_pallas(payload):
    idx, val, diag = _ell(48, seed=3)
    z = np.random.default_rng(1).standard_normal((48, 24)).astype(np.float32)
    got = ops.ell_spmm(*_t(idx, val, diag, z), payload_dtype=payload).numpy()
    z_src = jnp.asarray(z) if payload is None else jnp.asarray(z).astype(
        jnp.bfloat16)
    want_ref = np.asarray(jref.ell_spmm_ref(idx, val, diag, jnp.asarray(z),
                                            z_src))
    want_pallas = np.asarray(jops.ell_spmm(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(diag), jnp.asarray(z),
        payload_dtype=payload, use_pallas=True, interpret=True,
        block_rows=16))
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("path", ["fallback_gather", "fallback_dense",
                                  "fallback_scan"])
def test_ell_spmm_cpu_paths_match_reference(path, monkeypatch):
    """Each CPU form, chosen by the port's own ``ell_spmm_path``, against
    the reference's twin of that form."""
    kind = "ba" if path == "fallback_dense" else "ws"
    n, k = (60 if kind == "ba" else 160), 9
    idx, val, diag = _ell(n, seed=2, kind=kind)
    if path == "fallback_scan":        # force the scan at a small size
        monkeypatch.setattr(ops, "_ELL_GATHER_ELEMS", 0)
    assert ops.ell_spmm_path(n, idx.shape[1], k, use_kernel=False) == path
    z = np.random.default_rng(5).standard_normal((n, k)).astype(np.float32)
    twin = {"fallback_gather": jref.ell_spmm_ref,
            "fallback_dense": jref.ell_spmm_dense_ref,
            "fallback_scan": jref.ell_spmm_scan_ref}[path]
    for payload in (None, "bfloat16"):
        got = ops.ell_spmm(*_t(idx, val, diag, z),
                           payload_dtype=payload).numpy()
        z_src = jnp.asarray(z) if payload is None else jnp.asarray(z).astype(
            jnp.bfloat16)
        want = np.asarray(twin(jnp.asarray(idx), jnp.asarray(val),
                               jnp.asarray(diag), jnp.asarray(z), z_src))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,width,k", [(100, 4, 8), (100, 10, 8),
                                       (1 << 20, 64, 64), (4096, 10, 3920),
                                       (300, 9, 100)])
def test_ell_spmm_path_agrees_with_reference(n, width, k):
    assert (ops.ell_spmm_path(n, width, k, use_kernel=False)
            == jops.ell_spmm_path(n, width, k, use_pallas=False))
    assert ops.ell_densify_wins(n, width) == jops.ell_densify_wins(n, width)
    # on the card there is no size guard: always the kernel
    assert ops.ell_spmm_path(n, width, k, use_kernel=True) == "cuda"


def test_cpu_dispatch_runs_the_plain_version_and_launches_nothing():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 20)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 8, 3)).astype(np.float32))
    nt = torch.tensor([20.0, 20.0])
    assert torch.equal(ops.batched_gram_apply(x, q, nt),
                       ref.batched_gram_apply_ref(x, q, nt))
    assert torch.equal(ops.gram_apply(x[0], q[0]), ref.gram_apply_ref(x[0], q[0]))
    idx, val, diag = _t(*_ell(160))
    assert ops.ell_spmm_path(160, idx.shape[1], 4, False) == "fallback_gather"
    z = torch.from_numpy(rng.standard_normal((160, 4)).astype(np.float32))
    assert torch.equal(ops.ell_spmm(idx, val, diag, z),
                       ref.ell_spmm_ref(idx, val, diag, z, z))
    assert all(v == 0 for v in ops.LAUNCHES.values())
