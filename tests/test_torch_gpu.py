"""The port's Hopper kernels on the card: each against its plain version,
and S-DOT on the card against the same run on the CPU.

Every test here needs an NVIDIA H100 with nvcc and skips elsewhere. This
file imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import topology
from repro_torch.core.consensus import DenseConsensus
from repro_torch.core.linalg import orthonormal_init
from repro_torch.core.sdot import sdot
from repro_torch.core.sparse import SparseW
from repro_torch.data.pipeline import gaussian_eigengap_data, partition_samples
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100 with nvcc (sm_90a CUDA kernels)")
    return torch.device("cuda")


@contextlib.contextmanager
def no_host_sync():
    """Raise on any operation that makes the host wait for the device."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _ragged_stack(rng, n_true, d):
    x = np.zeros((len(n_true), d, int(max(n_true))), np.float32)
    for i, ni in enumerate(n_true):
        x[i, :, :ni] = rng.standard_normal((d, ni))
    return x


@pytest.mark.parametrize("n_true,d,r", [([2500] * 4, 1024, 7),
                                        ([14] * 64, 784, 5),
                                        ([300, 150, 512, 77], 96, 20),
                                        ([3, 1], 3000, 2)])
def test_gram_kernel_matches_plain(cuda_device, n_true, d, r):
    """Tolerance: f32 sums in another order, 1e-5 relative to max |V|."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_ragged_stack(rng, n_true, d)).to(cuda_device)
    q = torch.randn((len(n_true), d, r), device=cuda_device)
    nt = torch.tensor(n_true, dtype=torch.float32, device=cuda_device)
    before = ops.LAUNCHES["batched_gram_apply"]
    got = ops.batched_gram_apply(x, q, nt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["batched_gram_apply"] == before + 1
    want = ref.batched_gram_apply_ref(x, q, nt)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with no_host_sync():
        again = ops.batched_gram_apply(x, q, nt)
    assert torch.equal(got, again)          # fixed-order reduction
    x0 = x[0, :, :n_true[0]].contiguous()
    single = ops.gram_apply(x0, q[0])
    want0 = ref.gram_apply_ref(x0, q[0])
    assert float((single - want0).abs().max()) <= 1e-5 * float(
        want0.abs().max())


@pytest.mark.parametrize("payload", [None, "bfloat16"])
@pytest.mark.parametrize("k", [3920, 35, 1])
def test_ell_kernel_matches_plain(cuda_device, payload, k):
    """The same quantised source on both sides: f32-tight (1e-6 of |out|)."""
    sw = SparseW.from_graph(topology.watts_strogatz(512, k=6, p=0.1, seed=1),
                            device=cuda_device)
    z = torch.randn((512, k), device=cuda_device)
    before = ops.LAUNCHES["ell_spmm"]
    got = ops.ell_spmm(sw.ell_idx, sw.ell_val, sw.diag, z,
                       payload_dtype=payload)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ell_spmm"] == before + 1
    with no_host_sync():
        again = ops.ell_spmm(sw.ell_idx, sw.ell_val, sw.diag, z,
                             payload_dtype=payload)
    assert torch.equal(got, again)
    z_src = z if payload is None else z.to(torch.bfloat16)
    want = ref.ell_spmm_ref(sw.ell_idx, sw.ell_val, sw.diag, z, z_src)
    assert float((got - want).abs().max()) <= 1e-6 * float(
        want.abs().max()) + 1e-7


def test_wrappers_raise_instead_of_falling_back(cuda_device):
    x = torch.randn((2, 8, 16), device=cuda_device, dtype=torch.float64)
    q = torch.randn((2, 8, 3), device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError):
        ops.batched_gram_apply(x, q, torch.ones(2, device=cuda_device))
    idx = torch.zeros((4, 2), dtype=torch.int64, device=cuda_device)
    val = torch.zeros((4, 2), device=cuda_device)
    with pytest.raises(ValueError):
        ops.ell_spmm(idx, val, torch.ones(4, device=cuda_device),
                     torch.randn((4, 3), device=cuda_device))


def test_sdot_on_card_matches_cpu(cuda_device):
    """The raw-data S-DOT run through both kernels' paths: card vs CPU."""
    d, r, n = 48, 4, 10
    runs = {}
    for dev in ("cpu", "cuda"):
        x, _, _ = gaussian_eigengap_data(d, n * 300, r, 0.7, seed=0,
                                         device=dev)
        blocks = partition_samples(x, n)
        m = sum(b @ b.T / b.shape[1] for b in blocks)
        q_true = torch.linalg.eigh(m)[1][:, -r:]
        q0 = orthonormal_init(torch.Generator().manual_seed(0), d, r,
                              device=dev)
        eng = DenseConsensus(topology.erdos_renyi(n, 0.5, seed=1),
                             device=dev)
        ops.reset_launches()
        runs[dev] = sdot(data=blocks, engine=eng, r=r, t_outer=12, t_c=30,
                         q_init=q0, q_true=q_true, device=dev)
    assert ops.LAUNCHES["batched_gram_apply"] == 12
    np.testing.assert_allclose(runs["cuda"].error_trace,
                               runs["cpu"].error_trace, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sparse", [False, True])
def test_fused_sdot_loop_never_waits_for_the_device(cuda_device, sparse):
    """The fused run's iterations launch work and never sync: QR uses
    cholesky_ex, debiasing indexes the device table, and the error trace's
    SVDs wait for the end (not exercised here: q_true is None)."""
    d, r, n = 32, 3, 300
    g = topology.watts_strogatz(n, k=4, p=0.1, seed=1)
    eng = DenseConsensus(g, sparse=sparse, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn((n, d, d), generator=gen, device=cuda_device)
    covs = a @ a.mT / d
    q0 = orthonormal_init(torch.Generator().manual_seed(0), d, r,
                          device=cuda_device)
    kw = dict(covs=covs, engine=eng, r=r, t_outer=4, t_c=6, q_init=q0,
              device=cuda_device)
    warm = sdot(**kw)                       # builds the kernels and the table
    with no_host_sync():
        res = sdot(**kw)
    assert torch.equal(res.q_nodes, warm.q_nodes)
