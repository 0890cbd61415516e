"""The port's Hopper kernels on the card: each against its plain version;
S-DOT, F-DOT, B-DOT and the LM prefill on the card against the same runs on
the CPU; decode on the card against prefill on the card; a killed and
resumed chunked S-DOT run against the uninterrupted one, bit for bit; the
ELL kernel under a faulty round's operands, and async and faulty gossip and
S-DOT on the card against the CPU on the same draws; the sweeps' lane
dispatch against one launch a lane and the plain version, and the
baselines and a sweep at a small size; the stream, the sketches and the
serving loop at CIFAR-10 width (a stop-and-resume bit for bit, the card
copy of the served subspace swapped whole); two gloo ranks sharing the
card (S-DOT a node a process against the dense engine, with the exact
bytes staged through host memory; a PSA refresh and train step against
the same on CPU ranks); and, last, the f32 forward repeated after all of
that in the same process.

Every test here needs an NVIDIA H100 with nvcc and skips elsewhere. This
file imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch, reduced_config
from repro_torch.core import topology
from repro_torch.core.bdot import bdot
from repro_torch.core.consensus import DenseConsensus, consensus_schedule
from repro_torch.core.fdot import fdot
from repro_torch.core.linalg import cholesky_qr, orthonormal_init
from repro_torch.core.sdot import sdot
from repro_torch.core.sparse import SparseW
from repro_torch.data.pipeline import (drifting_eigengap_stream,
                                       gaussian_eigengap_data,
                                       make_lm_batch, partition_features,
                                       partition_samples)
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import (_launch, ell_spmm, gram_qr, gram_update,
                                 slab_ops)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models.transformer import (decode_step, forward,
                                            init_decode_state, init_params,
                                            tree_map)
from repro_torch.serving.query import QueryPath
from repro_torch.serving.service import (PSAService, ServiceConfig,
                                         service_summary)
from repro_torch.streaming.ingest import StreamingIngestor
from repro_torch.streaming.resume import sdot_chunked

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


def _routes_delta(module, before):
    return {k: v - before[k] for k, v in module.ROUTE_LAUNCHES.items()}


@pytest.mark.parametrize("n", [2500, 2498])    # TMA route, cp.async route
def test_gram_kernel_ignores_nan_padding(cuda_device, n):
    """Columns past ceil(n_true) hold NaN: the output is finite and equals
    the zero-padded stack's bit for bit (the kernel masks with a select)."""
    rng = np.random.default_rng(3)
    n_true = [n, n - 700, n - 1, 5]
    x = torch.from_numpy(_ragged_stack(rng, n_true, 1024)).to(cuda_device)
    x_nan = x.clone()
    for i, ni in enumerate(n_true):
        x_nan[i, :, ni:] = float("nan")
    q = torch.randn((4, 1024, 7), device=cuda_device)
    nt = torch.tensor(n_true, dtype=torch.float32, device=cuda_device)
    got = ops.batched_gram_apply(x_nan, q, nt)
    want = ops.batched_gram_apply(x, q, nt)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,how", [(2500, "tma"), (2498, "cp_async")])
def test_gram_kernel_staging_routes(cuda_device, n, how):
    """n % 4 == 0 streams X by TMA, any other n by cp.async (both past the
    packed route's PACKED_MAX_N): each launch is counted on its route, both
    hold the plain version (1e-5 of max |V|) and repeat their bits without
    a host wait."""
    x = torch.randn((20, 1024, n), device=cuda_device)
    q = torch.randn((20, 1024, 7), device=cuda_device)
    nt = torch.full((20,), float(n), device=cuda_device)
    before = dict(gram_update.ROUTE_LAUNCHES)
    got = ops.batched_gram_apply(x, q, nt)
    torch.cuda.synchronize()
    assert _routes_delta(gram_update, before) == {
        "tma": int(how == "tma"), "cp_async": int(how == "cp_async"),
        "packed": 0}
    want = ref.batched_gram_apply_ref(x, q, nt)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with no_host_sync():
        again = ops.batched_gram_apply(x, q, nt)
    assert torch.equal(got, again)


# The packed route (nodes of few samples) against the plain version: f32
# sums in another order, relative to max |V|; the tiled route read 7.1e-7
# at sdot_sparse's shape (chip_smoke.py's batched_gram_apply_sdot_sparse)
PACKED_GRAM_TOL = 1e-5


def _sparse_stack(dev, r, seed=0):
    """sdot_sparse's stack: 4,096 nodes of 784 x 16, n_true 14 or 15, the
    padding zero and, in a copy, NaN."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nt = 14.0 + (torch.rand(4096, generator=gen, device=dev) < 0.5).float()
    x = torch.randn((4096, 784, 16), generator=gen, device=dev)
    pad = torch.arange(16, device=dev) >= nt[:, None, None]
    x = torch.where(pad, 0.0, x)
    x_nan = torch.where(pad, float("nan"), x)
    q = torch.randn((4096, 784, r), generator=gen, device=dev)
    return x, x_nan, q, nt


@pytest.mark.parametrize("r", [1, 5, 8])
def test_packed_gram_route_matches_plain(cuda_device, r):
    """sdot_sparse's shape takes the packed route (one launch counted on
    ``ROUTE_LAUNCHES["packed"]``), holds the plain version within
    PACKED_GRAM_TOL, repeats its bits without a host wait, and gives the
    same bits where the padding holds NaN."""
    x, x_nan, q, nt = _sparse_stack(cuda_device, r)
    card = _launch.card(cuda_device.index or 0)
    assert gram_update.packed_plan(4096, 784, 16, r, *card).route == "packed"
    before = dict(gram_update.ROUTE_LAUNCHES)
    got = ops.batched_gram_apply(x_nan, q, nt)
    torch.cuda.synchronize()
    assert _routes_delta(gram_update, before) == {"tma": 0, "cp_async": 0,
                                                  "packed": 1}
    assert bool(torch.isfinite(got).all())
    want = ref.batched_gram_apply_ref(x, q, nt)
    assert float((got - want).abs().max()) <= PACKED_GRAM_TOL * float(
        want.abs().max())
    with no_host_sync():
        again = ops.batched_gram_apply(x_nan, q, nt)
        zeros = ops.batched_gram_apply(x, q, nt)
    assert torch.equal(got, again) and torch.equal(got, zeros)
    assert gram_update.ROUTE_LAUNCHES["packed"] == before["packed"] + 3


@pytest.mark.parametrize("n,r", [(14, 5), (3, 2), (8, 64), (16, 12)])
def test_packed_and_tiled_gram_routes_agree(cuda_device, n, r):
    """Single-column units (n % 4 != 0, r > 16) and float4 units with r past
    8: both routes forced hold the plain version and each other within
    PACKED_GRAM_TOL; forcing the packed route where it cannot take the
    shapes raises, and so does an unaligned q."""
    gen = torch.Generator(device=cuda_device).manual_seed(n * r)
    d = 96 if r > 16 else 784
    x = torch.randn((300, d, n), generator=gen, device=cuda_device)
    q = torch.randn((300, d, r), generator=gen, device=cuda_device)
    nt = torch.full((300,), float(n), device=cuda_device)
    want = ref.batched_gram_apply_ref(x, q, nt)
    scale = PACKED_GRAM_TOL * float(want.abs().max())
    fn = gram_update.batched_gram_apply_cuda
    packed, tiled = (fn(x, q, nt, route=k) for k in ("packed", "tiled"))
    torch.cuda.synchronize()
    assert float((packed - want).abs().max()) <= scale
    assert float((tiled - want).abs().max()) <= scale
    with pytest.raises(ValueError):
        fn(torch.randn((4, 5, 7), device=cuda_device),
           torch.randn((4, 5, 3), device=cuda_device),
           torch.full((4,), 7.0, device=cuda_device), route="packed")
    q_off = torch.empty(300 * d * r + 1, device=cuda_device)[1:].view(
        300, d, r)
    q_off.copy_(q)
    with pytest.raises(RuntimeError):
        fn(x, q_off, nt, route="packed")


@pytest.mark.parametrize("n,how", [(10_000, "tma"), (257, "cp_async")])
def test_slab_apply_staging_routes(cuda_device, n, how):
    """The same for the slab / grid apply kernel, on both of its grids."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((4, 5, 256, n), generator=gen, device=cuda_device)
    s = torch.randn((5, n, 7), generator=gen, device=cuda_device)
    xa, sa = x[0], torch.randn((5, n, 7), generator=gen, device=cuda_device)
    for kernel, plain in ((lambda: ops.grid_block_apply(x, s),
                           lambda: ref.grid_block_apply_ref(x, s)),
                          (lambda: ops.batched_slab_apply(xa, sa),
                           lambda: ref.batched_slab_apply_ref(xa, sa))):
        before = dict(slab_ops.ROUTE_LAUNCHES)
        got = kernel()
        torch.cuda.synchronize()
        assert _routes_delta(slab_ops, before) == {
            "tma": int(how == "tma"), "cp_async": int(how == "cp_async"),
            "packed": 0, "packed_cp_async": 0}
        assert _close(got, plain())
        with no_host_sync():
            again = kernel()
        assert torch.equal(got, again)


def test_kernel_plans_match_the_kernels_shared_memory(cuda_device):
    """The planners' byte counts are the kernels' own (one formula on each
    side of the ctypes boundary), at the main path's shapes."""
    for nodes, d, n, r in ((20, 1024, 2500, 7), (1, 1024, 50_000, 7),
                           (4096, 784, 16, 5)):
        p = gram_update._device_plan(cuda_device.index or 0, nodes, d, n,
                                     r)[0]
        assert gram_update._lib().gram_apply_smem_bytes(d, p.bn, p.stages) \
            == p.smem
    for blocks, d, n, r in ((20, 55, 50_000, 7), (20, 256, 10_000, 7)):
        p = slab_ops._device_apply_plan(cuda_device.index or 0, blocks, d, n,
                                        r)[0]
        assert slab_ops._lib().slab_apply_smem_bytes(
            p.rows, p.cols, r, p.stages) == p.smem
    # the packed routes at sdot_sparse's stack (4,096 nodes of 784 x 16)
    # and bdot_sparse's grid (4 x 4,096 blocks of 196 x 16)
    card = _launch.card(cuda_device.index or 0)
    p = gram_update.packed_plan(4096, 784, 16, 5, *card)
    assert p.route == "packed"
    assert gram_update._lib().gram_packed_smem_bytes(784, 16, 5, p.stages) \
        == p.smem
    for kernel in ("tq", "apply"):
        p = slab_ops.packed_plan(kernel, 16_384, 4096, 196, 16, 5, *card)
        assert p.route == "packed"
        assert slab_ops._lib().slab_packed_smem_bytes(
            int(kernel == "apply"), p.blocks_per_stage, 196, 16, 5,
            p.stages) == p.smem


@pytest.mark.parametrize("payload", [None, "bfloat16"])
@pytest.mark.parametrize("k", [3920, 35, 1])
def test_ell_kernel_matches_plain(cuda_device, payload, k):
    """The same quantised source on both sides: f32-tight (1e-6 of |out|)."""
    sw = SparseW.from_graph(topology.watts_strogatz(512, k=6, p=0.1, seed=1),
                            device=cuda_device)
    z = torch.randn((512, k), device=cuda_device)
    before = ops.LAUNCHES["ell_spmm"]
    got = ops.ell_spmm(sw.ell_idx, sw.ell_val, sw.diag, z,
                       payload_dtype=payload, window=sw.window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ell_spmm"] == before + 1
    with no_host_sync():
        again = ops.ell_spmm(sw.ell_idx, sw.ell_val, sw.diag, z,
                             payload_dtype=payload, window=sw.window)
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
    with pytest.raises(ValueError, match="window"):   # no graph plan
        ops.ell_spmm(idx.int(), val, torch.ones(4, device=cuda_device),
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


# ---------------------------------------------------------------------------
# slab and grid kernels (F-DOT / B-DOT)
# ---------------------------------------------------------------------------
SLAB_TOL = 1e-5      # f32 sums in another order than cuBLAS, rel. to max |out|


def _close(got, want):
    return float((got - want).abs().max()) <= SLAB_TOL * float(
        want.abs().max())


@pytest.mark.parametrize("grid,d,n,r", [((20, 1), 55, 50_000, 7),
                                        ((4, 5), 256, 10_000, 7),
                                        ((3, 2), 37, 700, 5),
                                        ((1, 3), 1300, 33, 20),
                                        ((2, 2), 5, 257, 64),
                                        ((1, 1), 1, 1, 1)])
def test_slab_and_grid_kernels_match_plain(cuda_device, grid, d, n, r):
    """Aligned and ragged shapes: n not a multiple of the 256-column tile,
    d and r not multiples of 4, a tall d staged in Q chunks (1300 rows at
    r = 20), r at the instantiated maximum. Each wrapper counts one launch
    per call, and a second launch gives the same bits."""
    i_rows, j_cols = grid
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((i_rows, j_cols, d, n), generator=gen, device=cuda_device)
    q = torch.randn((i_rows, d, r), generator=gen, device=cuda_device)
    s = torch.randn((j_cols, n, r), generator=gen, device=cuda_device)
    cases = [("grid_block_tq", lambda: ops.grid_block_tq(x, q),
              lambda: ref.grid_block_tq_ref(x, q)),
             ("grid_block_apply", lambda: ops.grid_block_apply(x, s),
              lambda: ref.grid_block_apply_ref(x, s))]
    if j_cols == 1:
        xs, qs = x[:, 0], q
        cases.append(("batched_slab_tq", lambda: ops.batched_slab_tq(xs, qs),
                      lambda: ref.batched_slab_tq_ref(xs, qs)))
    if i_rows == 1:
        xa = x[0]
        cases.append(("batched_slab_apply",
                      lambda: ops.batched_slab_apply(xa, s),
                      lambda: ref.batched_slab_apply_ref(xa, s)))
    for name, kernel, plain in cases:
        before = ops.LAUNCHES[name]
        got = kernel()
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name] == before + 1, name
        assert bool(torch.isfinite(got).all()), name
        assert _close(got, plain()), name
        with no_host_sync():
            again = kernel()
        assert torch.equal(got, again), name    # no atomics, fixed order


def test_grid_kernels_keep_zero_padding_exact(cuda_device):
    """Padded feature rows and sample columns (the B-DOT invariants) come out
    exactly zero, and the real part equals the unpadded product."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((2, 2, 6, 600), generator=gen, device=cuda_device)
    q = torch.randn((2, 6, 3), generator=gen, device=cuda_device)
    s = torch.randn((2, 600, 3), generator=gen, device=cuda_device)
    x[1, :, 4:] = 0.0
    q[1, 4:] = 0.0
    x[:, 1, :, 400:] = 0.0
    s[1, 400:] = 0.0
    z = ops.grid_block_tq(x, q)
    v = ops.grid_block_apply(x, s)
    assert torch.count_nonzero(z[:, 1, 400:]) == 0
    assert torch.count_nonzero(v[1, :, 4:]) == 0
    want = ref.grid_block_tq_ref(x[1:, 1:, :4, :400].contiguous(),
                                 q[1:, :4].contiguous())
    assert _close(z[1, 1, :400], want[0, 0])


# The packed route (many small blocks) against the plain versions: (I, J),
# d, n, r. bdot_sparse's block (196 x 16) and its unpadded 14 columns, n = 1
# and 3 at odd J, r = 1, r = 64 (single columns), d = 1, n = 32, and more
# than 65,535 blocks (past the tiled tq kernel's grid).
PACKED_CASES = [((4, 64), 196, 16, 5), ((4, 64), 196, 14, 5),
                ((3, 33), 20, 1, 5), ((2, 17), 37, 3, 1),
                ((2, 16), 50, 32, 64), ((4, 9), 1, 16, 5),
                ((2, 8), 196, 32, 5), ((8, 8192), 196, 16, 5)]


def _grid_route(kernel, blocks, j_cols, d, n, r, dev):
    """The route a grid launch should count: the planner's, with the
    staging the shapes allow (the tensors here are 16-byte aligned)."""
    p = slab_ops.packed_plan(kernel, blocks, j_cols, d, n, r,
                             *_launch.card(dev.index or 0))
    if p.route == "packed":
        bulk = (d * n) % 4 == 0 and (kernel == "tq" or (n * r) % 4 == 0)
        return "packed" if bulk else "packed_cp_async"
    if kernel == "tq":
        return "tiled"
    return "tma" if n % 4 == 0 else "cp_async"


def _check_grid_kernels(dev, grid, d, n, r, seed=0):
    """Both grid kernels against the plain versions (SLAB_TOL), on a grid
    whose row 1 has a quarter of its feature rows and column 1 a quarter of
    its sample columns zero-padded: the launch is counted on its route, the
    padding comes out exactly zero, and a second launch without a host
    wait repeats the bits."""
    i_rows, j_cols = grid
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((i_rows, j_cols, d, n), generator=gen, device=dev)
    q = torch.randn((i_rows, d, r), generator=gen, device=dev)
    s = torch.randn((j_cols, n, r), generator=gen, device=dev)
    d_true, n_true = d - d // 4, n - n // 4
    x[1, :, d_true:] = 0.0
    q[1, d_true:] = 0.0
    x[:, 1, :, n_true:] = 0.0
    s[1, n_true:] = 0.0
    routes = {}
    for kernel, counts, run, plain in (
            ("tq", slab_ops.TQ_ROUTE_LAUNCHES,
             lambda: ops.grid_block_tq(x, q),
             lambda: ref.grid_block_tq_ref(x, q)),
            ("apply", slab_ops.ROUTE_LAUNCHES,
             lambda: ops.grid_block_apply(x, s),
             lambda: ref.grid_block_apply_ref(x, s))):
        route = _grid_route(kernel, i_rows * j_cols, j_cols, d, n, r, dev)
        before = dict(counts)
        got = run()
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in counts.items()} == {
            k: int(k == route) for k in counts}, (kernel, route)
        assert bool(torch.isfinite(got).all()), kernel
        assert _close(got, plain()), kernel
        with no_host_sync():
            again = run()
        assert torch.equal(got, again), kernel   # no atomics, fixed order
        padded = got[:, 1, n_true:] if kernel == "tq" else got[1, :, d_true:]
        assert torch.count_nonzero(padded) == 0, kernel
        routes[kernel] = route
    return routes


@pytest.mark.parametrize("grid,d,n,r", PACKED_CASES)
def test_packed_grid_kernels_match_plain(cuda_device, grid, d, n, r):
    routes = _check_grid_kernels(cuda_device, grid, d, n, r)
    assert routes["tq"].startswith("packed")
    assert routes["apply"].startswith("packed")


@pytest.mark.parametrize("past", [0, 1])
@pytest.mark.parametrize("kernel", ["tq", "apply"])
def test_packed_route_ends_at_the_crossover(cuda_device, kernel, past):
    """At n = PACKED_MAX_N the planner takes the packed route, one column
    past it the tiled kernel; both hold the plain version there."""
    n = slab_ops.PACKED_MAX_N[kernel] + past
    routes = _check_grid_kernels(cuda_device, (2, 8), 196, n, 5, seed=3)
    assert routes[kernel].startswith("packed") == (past == 0)


def test_packed_and_tiled_routes_agree(cuda_device):
    """At bdot_sparse's block both routes, forced, hold the plain version
    and each other within SLAB_TOL; forcing the packed route where the
    packed kernel cannot take the shapes raises."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn((256, 196, 16), generator=gen, device=cuda_device)
    q = torch.randn((4, 196, 5), generator=gen, device=cuda_device)
    s = torch.randn((64, 16, 5), generator=gen, device=cuda_device)
    for fn, y in ((slab_ops.slab_tq_cuda, q), (slab_ops.slab_apply_cuda, s)):
        packed, tiled = (fn(x, y, 64, route=k) for k in ("packed", "tiled"))
        assert _close(packed, tiled)
    wide = torch.randn((8, 196, 257), generator=gen, device=cuda_device)
    with pytest.raises(ValueError):
        slab_ops.slab_apply_cuda(wide, torch.randn(
            (4, 257, 5), generator=gen, device=cuda_device), 4,
            route="packed")


def test_slab_wrappers_raise_instead_of_falling_back(cuda_device):
    x = torch.randn((2, 8, 16), device=cuda_device)
    q = torch.randn((2, 8, 3), device=cuda_device)
    with pytest.raises(ValueError):
        ops.batched_slab_tq(x.double(), q.double())
    with pytest.raises(ValueError):
        ops.batched_slab_apply(x, torch.randn((2, 16, 65), device=cuda_device))
    with pytest.raises(ValueError):
        ops.grid_block_apply(x[None], torch.randn((3, 16, 4),
                                                  device=cuda_device))


def _fdot_problem(dev):
    d, r, n_nodes = 24, 4, 7
    x, _, _ = gaussian_eigengap_data(d, 3000, r, 0.7, seed=0, device=dev)
    q_true = torch.linalg.eigh(x @ x.T)[1][:, -r:]
    q0 = orthonormal_init(torch.Generator().manual_seed(0), d, r, device=dev)
    eng = DenseConsensus(topology.erdos_renyi(n_nodes, 0.6, seed=2),
                         device=dev)
    return dict(data_blocks=partition_features(x, n_nodes), engine=eng, r=r,
                q_init=q0, q_true=q_true, device=dev)


def _bdot_problem(dev):
    d, r, i_rows, j_cols = 25, 4, 3, 2
    x, _, _ = gaussian_eigengap_data(d, 3000, r, 0.6, seed=0, device=dev)
    q_true = torch.linalg.eigh(x @ x.T)[1][:, -r:]
    q0 = orthonormal_init(torch.Generator().manual_seed(0), d, r, device=dev)
    sizes = [1600, 1400]                  # ragged n_j and (25 / 3) ragged d_i
    blocks = [list(torch.split(sl, sizes, dim=1))
              for sl in partition_features(x, i_rows)]
    cols = [DenseConsensus(topology.erdos_renyi(i_rows, 0.7, seed=j),
                           device=dev) for j in range(j_cols)]
    rows = [DenseConsensus(topology.ring(j_cols), device=dev)
            for _ in range(i_rows)]
    return dict(blocks=blocks, col_engines=cols, row_engines=rows, r=r,
                q_init=q0, q_true=q_true, device=dev)


@pytest.mark.parametrize("algo", ["fdot", "bdot"])
def test_fused_fdot_bdot_on_card_match_cpu(cuda_device, algo):
    """The fused runs through the slab/grid kernels on the card against the
    same runs on the CPU (plain versions): traces within 1e-5."""
    run, problem = ((fdot, _fdot_problem) if algo == "fdot"
                    else (bdot, _bdot_problem))
    launches = {"fdot": ("batched_slab_tq", "batched_slab_apply"),
                "bdot": ("grid_block_tq", "grid_block_apply")}[algo]
    sched = consensus_schedule("lin2", 15, cap=40)
    traces = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launches()
        res = run(t_outer=15, schedule=sched, t_c_qr=40, **problem(dev))
        traces[dev] = res.error_trace
        q = res.q_full
        eye = torch.eye(4, device=q.device)
        assert float((q.T @ q - eye).abs().max()) < 1e-5
    assert all(ops.LAUNCHES[k] == 15 for k in launches)
    np.testing.assert_allclose(traces["cuda"], traces["cpu"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("algo", ["fdot", "bdot"])
def test_fused_fdot_bdot_loops_never_wait_for_the_device(cuda_device, algo):
    """No host sync inside the fused loops: debias by a device-table row,
    cholesky_ex and a batched triangular solve (q_true is None, so the
    error trace's SVDs do not run)."""
    run, problem = ((fdot, _fdot_problem) if algo == "fdot"
                    else (bdot, _bdot_problem))
    kw = dict(problem(cuda_device), q_true=None, t_outer=4, t_c=6)
    warm = run(**kw)                       # builds the kernels and the tables
    with no_host_sync():
        res = run(**kw)
    assert torch.equal(res.q_full, warm.q_full)


# ---------------------------------------------------------------------------
# flash attention and the LM serving stack
# ---------------------------------------------------------------------------
# Kernel against plain. f32: 1e-5 of max |out| (sums in another order).
# bf16: each side rounds an f32 result to bf16 once, so a pair straddling a
# rounding boundary lands one ulp apart: at most 2^-7 of the largest |out|
# in its own row (a tensor-wide max would hide faults in the long rows,
# whose outputs are small); only such pairs differ, so the relative RMS of
# the difference stays within half an ulp, 2^-8.
ATTN_F32_TOL = 1e-5
ATTN_BF16_TOL = 2.0 ** -7
ATTN_BF16_RMS_TOL = 2.0 ** -8


def _attn_inputs(dev, dtype, b, hq, hkv, sq, skv, hd, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, hq, sq, hd), (b, hkv, skv, hd),
                          (b, hkv, skv, hd))]


def _assert_attn_close(got, want):
    assert got.dtype == want.dtype
    dtype = got.dtype
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= ATTN_F32_TOL * max(
            float(want.abs().max()), 1e-30)
        return
    row_err = diff.amax(-1)
    assert bool((row_err <= ATTN_BF16_TOL * want.abs().amax(-1)).all())
    assert float(diff.square().sum().sqrt()) <= ATTN_BF16_RMS_TOL * float(
        want.square().sum().sqrt())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,hd,causal,window", [
    (2, 4, 4, 256, 256, 64, True, None),        # causal, whole tiles
    (1, 14, 2, 200, 200, 128, True, None),      # GQA 7:1, ragged sq = skv
    (1, 4, 2, 300, 300, 32, True, 64),          # sliding window
    (1, 2, 2, 130, 130, 16, True, 1),           # window of one key
    (2, 4, 1, 64, 500, 80, True, None),         # sq < skv, danube's hd
    (1, 2, 2, 1, 333, 16, True, None),          # one query (decode-like)
    (1, 4, 2, 96, 160, 128, False, None),       # not causal
    (1, 2, 1, 70, 70, 128, False, 20),          # window without causal
])
def test_flash_kernel_matches_plain(cuda_device, b, hq, hkv, sq, skv, hd,
                                    causal, window, dtype):
    q, k, v = _attn_inputs(cuda_device, dtype, b, hq, hkv, sq, skv, hd)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=skv - sq, kv_valid=skv)
    assert bool(torch.isfinite(got).all())
    _assert_attn_close(got, want)
    with no_host_sync():
        again = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_offsets_and_masked_rows(cuda_device, dtype):
    """The kernel's own q_offset / kv_valid arguments, as the reference's
    Pallas kernel takes them; rows before the first key come out zero."""
    q, k, v = _attn_inputs(cuda_device, dtype, 2, 4, 2, 150, 260, 64, seed=3)
    for kw in (dict(causal=True, window=None, q_offset=40, kv_valid=190),
               dict(causal=True, window=70, q_offset=-20, kv_valid=260),
               dict(causal=False, window=None, q_offset=0, kv_valid=0)):
        got = flash_attention_cuda(q, k, v, scale=0.1, **kw)
        want = ref.flash_attention_plain(q, k, v, scale=0.1, **kw)
        _assert_attn_close(got, want)
    assert torch.equal(got, torch.zeros_like(got))          # kv_valid = 0


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128, 256])
def test_flash_kernel_rows_sum_to_one(cuda_device, hd):
    q, k, _ = _attn_inputs(cuda_device, torch.float32, 1, 4, 2, 190, 190, hd)
    v = torch.ones_like(k)
    out = ops.flash_attention(q, k, v, causal=True, window=50)
    assert float((out - 1.0).abs().max()) <= 1e-5


def test_flash_kernel_raises_on_what_it_does_not_take(cuda_device):
    q, k, v = _attn_inputs(cuda_device, torch.float32, 1, 2, 2, 8, 8, 48)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q, k, v)
    q, k, v = _attn_inputs(cuda_device, torch.float32, 1, 2, 2, 8, 8, 512)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q, k, v)
    q, k, v = _attn_inputs(cuda_device, torch.float16, 1, 2, 2, 8, 8, 64)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)
    q, k, v = _attn_inputs(cuda_device, torch.float32, 1, 2, 2, 8, 8, 64)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.bfloat16(), v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,group,q_head0,hd",
                         [(4, 2, 7, 4, 128), (3, 1, 10, 5, 256),
                          (5, 3, 2, 3, 64)])
def test_flash_kernel_head_offset_matches_plain(cuda_device, hq, hkv, group,
                                                q_head0, hd, dtype):
    """A model rank's query heads that straddle GQA groups: query head i of
    the launch reads kv head (q_head0 + i) // group - q_head0 // group of
    the k / v it is given, on both kernels, against the plain version with
    the same map and against the default map on k / v expanded to the
    launch's heads."""
    q, k, v = _attn_inputs(cuda_device, dtype, 2, hq, hkv, 300, 300, hd,
                           seed=q_head0)
    got = ops.flash_attention(q, k, v, causal=True, group=group,
                              q_head0=q_head0)
    want = ref.flash_attention_plain(q, k, v, causal=True, q_offset=0,
                                     kv_valid=300, group=group,
                                     q_head0=q_head0)
    _assert_attn_close(got, want)
    assert torch.equal(got, ops.flash_attention(
        q, ref.expand_kv(k, hq, group, q_head0).contiguous(),
        ref.expand_kv(v, hq, group, q_head0).contiguous(), causal=True))


# bf16 goes to the tensor-core kernel (wgmma, TMA; head dims padded to 64,
# 128 or 256 in its tiles), f32 to the CUDA-core kernel; ROUTE_LAUNCHES
# shows which.
TILE_EDGES = (1, 63, 64, 65, 127, 128, 129, 2000)


def _routes_after(before, **added):
    return {name: before[name] + added.get(name, 0) for name in before}


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128, 256])
def test_flash_bf16_runs_on_the_tensor_core_route(cuda_device, hd):
    q, k, v = _attn_inputs(cuda_device, torch.bfloat16, 2, 6, 2, 300, 300,
                           hd, seed=hd)
    before = dict(fa.ROUTE_LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES == _routes_after(before, tc_bf16=1)
    want = ref.flash_attention_plain(q, k, v, causal=True, q_offset=0,
                                     kv_valid=300)
    _assert_attn_close(got, want)
    again = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, again)


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_f32_runs_on_the_cuda_core_route(cuda_device, hd):
    q, k, v = _attn_inputs(cuda_device, torch.float32, 1, 4, 2, 130, 130, hd)
    before = dict(fa.ROUTE_LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES == _routes_after(before, simt_f32=1)
    want = ref.flash_attention_plain(q, k, v, causal=True, q_offset=0,
                                     kv_valid=130)
    _assert_attn_close(got, want)


@pytest.mark.parametrize("sq,skv", [(sq, skv) for sq in TILE_EDGES
                                    for skv in TILE_EDGES if sq <= skv])
def test_flash_tensor_core_tile_edges(cuda_device, sq, skv):
    """Query and key lengths on either side of the kernel's 64-row
    warpgroup tiles and 128-row / 128-key block tiles, causal with the
    queries at the end of the key stream."""
    q, k, v = _attn_inputs(cuda_device, torch.bfloat16, 1, 4, 2, sq, skv,
                           128, seed=sq + skv)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_plain(q, k, v, causal=True,
                                     q_offset=skv - sq, kv_valid=skv)
    assert bool(torch.isfinite(got).all())
    _assert_attn_close(got, want)


@pytest.mark.parametrize("hd", [80, 128, 256])
@pytest.mark.parametrize("kw", [
    dict(causal=True, window=None, q_offset=-20, kv_valid=260),
    dict(causal=True, window=None, q_offset=40, kv_valid=190),
    dict(causal=True, window=1, q_offset=110, kv_valid=260),
    dict(causal=True, window=70, q_offset=-20, kv_valid=260),
    dict(causal=False, window=None, q_offset=0, kv_valid=200),
    dict(causal=False, window=None, q_offset=0, kv_valid=0),
], ids=["q_offset_neg", "q_offset_pos", "window1", "window70_neg",
        "not_causal", "kv_valid0"])
def test_flash_tensor_core_masks(cuda_device, hd, kw):
    """The kernel's own arguments on the tensor-core route: rows before the
    first key, keys past kv_valid, a window of one key; the same bits on a
    second launch."""
    q, k, v = _attn_inputs(cuda_device, torch.bfloat16, 2, 4, 2, 150, 260,
                           hd, seed=7)
    before = dict(fa.ROUTE_LAUNCHES)
    got = flash_attention_cuda(q, k, v, scale=hd ** -0.5, **kw)
    again = flash_attention_cuda(q, k, v, scale=hd ** -0.5, **kw)
    torch.cuda.synchronize()
    assert fa.ROUTE_LAUNCHES == _routes_after(before, tc_bf16=2)
    want = ref.flash_attention_plain(q, k, v, scale=hd ** -0.5, **kw)
    _assert_attn_close(got, want)
    assert torch.equal(got, again)
    if kw["kv_valid"] == 0:
        assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,window", [
    (600, 600, None),           # paligemma's 8 / 1 heads, causal
    (600, 600, 100),            # recurrentgemma's window, shortened
    (63, 65, None), (129, 129, 64), (1, 300, None),   # 64-key tile edges
])
def test_flash_head_dim_256_matches_plain(cuda_device, sq, skv, window,
                                          dtype):
    """Head dim 256 (recurrentgemma-2b, paligemma-3b): 64-key tiles in a
    two-stage ring on the tensor cores, 32-key tiles on the CUDA cores;
    10 query heads on one kv head; the same bits on a second launch."""
    q, k, v = _attn_inputs(cuda_device, dtype, 1, 10, 1, sq, skv, 256,
                           seed=sq + skv)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_plain(q, k, v, causal=True, window=window,
                                     q_offset=skv - sq, kv_valid=skv)
    assert bool(torch.isfinite(got).all())
    _assert_attn_close(got, want)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True,
                                                window=window))


def test_flash_tensor_core_reads_unaligned_views(cuda_device):
    """TMA needs 16-byte-aligned bases: a contiguous view that starts one
    element into its storage goes through a copy, with the same result."""
    q, k, v = _attn_inputs(cuda_device, torch.bfloat16, 1, 2, 2, 96, 96, 64)
    flat = torch.empty(q.numel() + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    q_view = flat[1:].view(q.shape)
    q_view.copy_(q)
    assert q_view.data_ptr() % fa.TMA_ALIGN != 0
    assert torch.equal(ops.flash_attention(q_view, k, v),
                       ops.flash_attention(q, k, v))


def _lm_setup(dev):
    """Reduced qwen2-7b (f32, 3 layers) on the CPU and a copy on ``dev``."""
    cfg = reduced_config(get_arch("qwen2-7b"), n_layers=3)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = make_lm_batch(cfg, 0, 0, 2, 256, device="cpu")["tokens"]
    return (cfg, tree_map(lambda t: t.to(dev), params), toks.to(dev), params,
            toks)


def test_forward_on_card_matches_cpu(cuda_device):
    """Reduced qwen2-7b (f32, 3 layers, S = 256: four kernel tiles) through
    the kernel on the card against the plain version on the CPU.
    Tolerance 1e-4: f32 in another order through three blocks (the CPU
    parity tests see ~6e-6 at logits of ~4)."""
    cfg, params, toks, cpu_params, cpu_toks = _lm_setup(cuda_device)
    ops.reset_launches()
    with torch.inference_mode():
        got = forward(params, {"tokens": toks}, cfg)
        want = forward(cpu_params, {"tokens": cpu_toks}, cfg)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert fa.ROUTE_LAUNCHES == {"tc_bf16": 0, "simt_f32": cfg.n_layers}
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("aid", ["recurrentgemma-2b", "phi3.5-moe-42b-a6.6b",
                                 "xlstm-1.3b", "paligemma-3b",
                                 "musicgen-medium"])
def test_family_forward_on_card_matches_cpu(cuda_device, aid):
    """The MoE, recurrent and frontend families, reduced, f32, S = 256,
    on the card (attention through the kernel, one launch an attention
    layer, all on the CUDA-core route) against the CPU. Tolerance 1e-4 as
    the qwen2-7b forward above: f32 summed in another order."""
    cfg = reduced_config(get_arch(aid))
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = make_lm_batch(cfg, 0, 0, 2, 256, device="cpu")
    batch.pop("labels")
    n_attn = cfg.n_groups * sum(kind in ("attn", "swa")
                                for kind in cfg.pattern_for_layers())
    ops.reset_launches()
    with torch.inference_mode():
        got = forward(tree_map(lambda t: t.to(cuda_device), params),
                      tree_map(lambda t: t.to(cuda_device), batch), cfg)
        want = forward(params, batch, cfg)
    assert ops.LAUNCHES["flash_attention"] == n_attn
    assert fa.ROUTE_LAUNCHES == {"tc_bf16": 0, "simt_f32": n_attn}
    assert got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_decode_on_card_matches_prefill_on_card(cuda_device):
    """Teacher-forced decode_step against forward, both on the card (f32;
    1e-4 as above: the same arithmetic, summed in another order)."""
    cfg, params, toks, _, _ = _lm_setup(cuda_device)
    toks = toks[:, :40]
    with torch.inference_mode():
        want = forward(params, {"tokens": toks}, cfg)
        state = init_decode_state(cfg, 2, 40, device=cuda_device)
        outs = []
        for t in range(40):
            lg, state = decode_step(params, state, toks[:, t:t + 1], cfg)
            outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, dim=1), want, rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the CholeskyQR Gram kernel and checkpointed resume
# ---------------------------------------------------------------------------
GRAM_QR_TOL = 1e-5   # f32 sums in another order, relative to max |G|


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,d,r", [(20, 1024, 7), (1, 1031, 7),
                                       (20, 55, 7), (1, 16421, 128),
                                       (20, 3001, 64), (4, 257, 13),
                                       (1, 5000, 33), (2, 1, 3)])
def test_gram_qr_kernel_matches_plain(cuda_device, dtype, batch, d, r):
    """Ragged d (no multiple of any tile or range), one pass and two:
    within GRAM_QR_TOL of the plain version, the same bits on a second
    launch, and exactly symmetric."""
    gen = torch.Generator(device=cuda_device).manual_seed(batch + d + r)
    v = torch.randn((batch, d, r), generator=gen, device=cuda_device).to(dtype)
    before = ops.LAUNCHES["gram_qr"]
    got = ops.gram_qr(v)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gram_qr"] == before + 1
    assert got.shape == (batch, r, r) and got.dtype == torch.float32
    want = ref.gram_qr_ref(v)
    assert float((got - want).abs().max()) <= GRAM_QR_TOL * float(
        want.abs().max())
    with no_host_sync():
        again = ops.gram_qr(v)
    assert torch.equal(got, again)          # fixed-order reduction
    assert torch.equal(got, got.mT)


def test_gram_qr_wrapper_raises_instead_of_falling_back(cuda_device):
    for dtype in (torch.float64, torch.float16, torch.int32):
        with pytest.raises(ValueError):
            ops.gram_qr(torch.ones((3, 40, 5), dtype=dtype,
                                   device=cuda_device))
    # so CholeskyQR takes no f64 on the card (the kernel has no f64 form)
    with pytest.raises(ValueError):
        cholesky_qr(torch.ones((40, 5), dtype=torch.float64,
                               device=cuda_device))


def test_sdot_cholesky_qr_goes_through_the_gram_kernel(cuda_device):
    """Two Gram launches per outer iteration (CholeskyQR2), none on the CPU."""
    d, r, n = 64, 5, 8
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn((n, d, d), generator=g, device=cuda_device)
    eng = DenseConsensus(topology.erdos_renyi(n, 0.5, seed=1),
                         device=cuda_device)
    q0 = orthonormal_init(torch.Generator().manual_seed(0), d, r,
                          device=cuda_device)
    ops.reset_launches()
    sdot(covs=a @ a.mT / d, engine=eng, r=r, t_outer=6, t_c=10, q_init=q0,
         device=cuda_device)
    assert ops.LAUNCHES["gram_qr"] == 2 * 6


def test_sdot_kill_and_resume_is_bitwise_on_card(cuda_device, tmp_path):
    """A raw-data S-DOT run killed after 2 chunks of 4 and resumed from its
    checkpoint gives the uninterrupted run's trace, iterate and ledger, bit
    for bit; so does a run chunked by 3."""
    d, r, n = 96, 4, 10
    x, _, _ = gaussian_eigengap_data(d, n * 400, r, 0.7, seed=0,
                                     device=cuda_device)
    blocks = partition_samples(x, n)
    q_true = torch.linalg.eigh(sum(b @ b.T for b in blocks))[1][:, -r:]
    kw = dict(data=blocks,
              engine=DenseConsensus(topology.erdos_renyi(n, 0.5, seed=1),
                                    device=cuda_device),
              r=r, t_outer=14, t_c=20, q_true=q_true,
              q_init=orthonormal_init(torch.Generator().manual_seed(0), d, r,
                                      device=cuda_device),
              device=cuda_device)
    mono = sdot(**kw)
    mgr = CheckpointManager(str(tmp_path))
    sdot_chunked(chunk_size=4, manager=mgr, max_chunks=2, **kw)
    assert mgr.latest_step() == 8
    runs = [sdot_chunked(chunk_size=4, manager=mgr, **kw),
            sdot_chunked(chunk_size=3, **kw)]
    for res in runs:
        np.testing.assert_array_equal(res.error_trace, mono.error_trace)
        assert torch.equal(res.q_nodes, mono.q_nodes)
        assert res.ledger == mono.ledger


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 7, 8, 9, 64, 128])
@pytest.mark.parametrize("d", [1, 3, 55, 1023, 1025, 16384])
def test_gram_qr_kernel_at_plan_shapes(cuda_device, dtype, d, r):
    """The plan tests' shapes (tests/test_torch_kernel_plans.py) on the
    card: one launch on the route the plan names, exactly symmetric, the
    same bits twice, within GRAM_QR_TOL of the Gram in float64 (the plain
    version in f32 is itself 1.1e-5 of max |G| off it at (3, 16384, r) on
    the card: cuBLAS's batched f32 product)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 131 + r)
    v = torch.randn((3, d, r), generator=gen, device=cuda_device).to(dtype)
    ops.reset_launches()
    got = ops.gram_qr(v)
    torch.cuda.synchronize()
    how = gram_qr.plan(3, d, r, dtype == torch.bfloat16,
                       _launch.card(cuda_device.index or 0)[0]).route
    assert ops.LAUNCHES["gram_qr"] == 1
    assert gram_qr.ROUTE_LAUNCHES == {"tc_bf16": int(how == "tc_bf16"),
                                      "simt": int(how == "simt"),
                                      "cluster": int(how == "cluster")}
    want = ref.gram_qr_ref(v.double())
    assert float((got - want).abs().max()) <= GRAM_QR_TOL * float(
        want.abs().max())
    with no_host_sync():
        again = ops.gram_qr(v)
    assert torch.equal(got, again) and torch.equal(got, got.mT)


# the PSA trainer's refresh Grams (train_psa: qwen2-7b's d_model and d_ff
# leaves two a launch, its head one; train_psa_moe: phi3.5-moe's expert
# stacks and head), ragged d, other widths
QR_CLUSTER_SHAPES = [(2, 3584, 64), (2, 18944, 64), (3584, 64),
                     (1, 4096, 64), (1, 6400, 64), (4096, 64),
                     (1, 3583, 64), (1, 4095, 64), (1, 6401, 64),
                     (1, 4096, 9), (1, 4096, 33), (2, 5000, 64)]


@pytest.mark.parametrize("shape", QR_CLUSTER_SHAPES)
def test_gram_qr_cluster_route_at_refresh_shapes(cuda_device, shape):
    """The plan takes the cluster route at the refresh's shapes (and at
    ragged d and r): one launch counted on it, within GRAM_QR_TOL of the
    Gram in float64, exactly symmetric, the same bits twice. GRAM_QR_TOL
    is the staged route's; the cluster route read at most 2.0e-7 of max
    |G| from float64 at the refresh shapes on an H100, and cuBLAS's f32
    Gram 6.6e-6 (tools/gram_qr_accuracy.py)."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    v = torch.randn(shape, generator=gen, device=cuda_device)
    batch = 1 if len(shape) == 2 else shape[0]
    p = gram_qr.plan(batch, *shape[-2:], False,
                     _launch.card(cuda_device.index or 0)[0])
    assert p.route == "cluster"
    ops.reset_launches()
    got = ops.gram_qr(v)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gram_qr"] == 1
    assert gram_qr.ROUTE_LAUNCHES == {"tc_bf16": 0, "simt": 0, "cluster": 1}
    want = ref.gram_qr_ref(v.double())
    assert float((got - want).abs().max()) <= GRAM_QR_TOL * float(
        want.abs().max())
    with no_host_sync():
        again = ops.gram_qr(v)
    assert torch.equal(got, again) and torch.equal(got, got.mT)


@pytest.mark.parametrize("d,r", [(55, 64), (700, 16), (16384, 128)])
def test_gram_qr_cluster_route_forced_matches_staged(cuda_device, d, r):
    """The cluster route forced where the plan may not take it (one short
    matrix; three tile pairs) against the staged route on the same V:
    within GRAM_QR_TOL of max |G| of each other, both exactly symmetric."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + r)
    v = torch.randn((1, d, r), generator=gen, device=cuda_device)
    got = gram_qr.gram_qr_cuda(v, route="cluster")
    want = gram_qr.gram_qr_cuda(v, route="simt")
    assert float((got - want).abs().max()) <= GRAM_QR_TOL * float(
        want.abs().max())
    assert torch.equal(got, got.mT) and torch.equal(want, want.mT)


def test_gram_qr_cluster_route_raises_instead_of_falling_back(
        cuda_device, monkeypatch):
    """A cluster launch the kernel refuses (here 32 blocks a cluster, past
    the card's 16) raises, and no route counts a launch; a route that
    cannot take the shapes is refused before any launch."""
    import dataclasses
    v = torch.randn((1, 4096, 64), device=cuda_device)
    real = gram_qr.plan
    monkeypatch.setattr(gram_qr, "plan", lambda *a: dataclasses.replace(
        real(*a), cluster=32, clusters=4))
    gram_qr._device_plan.cache_clear()
    ops.reset_launches()
    try:
        with pytest.raises(RuntimeError):
            gram_qr.gram_qr_cuda(v)
    finally:
        gram_qr._device_plan.cache_clear()
    assert gram_qr.ROUTE_LAUNCHES == {"tc_bf16": 0, "simt": 0, "cluster": 0}
    monkeypatch.setattr(gram_qr, "plan", real)
    for shape, dtype in (((1, 4096, 7), torch.float32),
                         ((1, 4096, 64), torch.bfloat16)):
        with pytest.raises(ValueError):
            gram_qr.gram_qr_cuda(torch.ones(shape, dtype=dtype,
                                            device=cuda_device),
                                 route="cluster")


def test_gram_qr_kernel_reads_unaligned_views(cuda_device):
    """A view that starts 4 bytes into its storage: the wrapper copies it
    to an aligned buffer for the 16-byte copies; the same bits as the
    aligned tensor."""
    flat = torch.randn(20 * 1024 * 7 + 1, device=cuda_device)
    v = flat[1:].view(20, 1024, 7)
    assert v.data_ptr() % 16 != 0
    assert torch.equal(ops.gram_qr(v), ops.gram_qr(v.clone()))


def test_gram_qr_cluster_route_reads_unaligned_views(cuda_device):
    """The same on the cluster route, at a refresh shape."""
    flat = torch.randn(4096 * 64 + 1, device=cuda_device)
    v = flat[1:].view(1, 4096, 64)
    assert v.data_ptr() % 16 != 0
    ops.reset_launches()
    assert torch.equal(ops.gram_qr(v), ops.gram_qr(v.clone()))
    assert gram_qr.ROUTE_LAUNCHES["cluster"] == 2


def _ell_graph(kind, n, dev):
    g = (topology.watts_strogatz(n, k=6, p=0.1, seed=1) if kind == "ws"
         else topology.erdos_renyi(n, 6 / n, seed=1, ensure_connected=False))
    return SparseW.from_graph(g, device=dev)


@pytest.mark.parametrize("payload", [None, "bfloat16"])
@pytest.mark.parametrize("k", [3920, 35, 1])
@pytest.mark.parametrize("kind", ["ws", "er"])
def test_ell_kernel_on_local_and_random_graphs(cuda_device, kind, k,
                                               payload):
    """Watts-Strogatz (a halo) and Erdos-Renyi (none), ragged K: one launch
    a round, within ELL's 1e-6 of the plain version on the same quantised
    source, the same bits twice."""
    sw = _ell_graph(kind, 1024, cuda_device)
    assert sw.window.halo == (2 if kind == "ws" else 0)
    z = torch.randn((1024, k), device=cuda_device)
    before = ops.LAUNCHES["ell_spmm"]
    got = sw.mix(z) if payload is None else SparseW(
        sw.ell_idx, sw.ell_val, sw.diag, sw.row_nnz, sw.n, sw.ell_width,
        payload, window=sw.window).mix(z)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ell_spmm"] == before + 1
    with no_host_sync():
        again = ops.ell_spmm(sw.ell_idx, sw.ell_val, sw.diag, z,
                             payload_dtype=payload, window=sw.window)
    assert torch.equal(got, again)
    z_src = z if payload is None else z.to(torch.bfloat16)
    want = ref.ell_spmm_ref(sw.ell_idx, sw.ell_val, sw.diag, z, z_src)
    assert float((got - want).abs().max()) <= 1e-6 * float(
        want.abs().max()) + 1e-7


# (band, halo): wide and narrow bands, no halo and a wide one
ELL_WINDOWS = [(64, 0), (32, 2), (16, 16), (8, 0), (1, 4)]


@pytest.mark.parametrize("kind", ["ws", "er"])
def test_ell_bits_do_not_depend_on_the_window(cuda_device, kind):
    """Every staging (more or fewer messages from shared memory, the rest
    from device memory), the 4-byte route of an unaligned view,
    and the one-launch bf16 round against the kernel fed a source quantised
    beforehand: the same FMA chain in slot order, so the same bits."""
    sw = _ell_graph(kind, 1024, cuda_device)
    args = (sw.ell_idx, sw.ell_val, sw.diag)
    z = torch.randn((1024, 3920), device=cuda_device)
    flat = torch.empty(1024 * 3920 + 1, device=cuda_device)
    z_view = flat[1:].view(1024, 3920)
    z_view.copy_(z)
    assert z_view.data_ptr() % 16 != 0
    windows = [sw.window] + [ell_spmm.WindowPlan(*w, 0, 1)
                             for w in ELL_WINDOWS]
    for quantise in (False, True):
        runs = [ell_spmm.ell_spmm_cuda(*args, z, quantise=quantise,
                                       window=w) for w in windows]
        runs.append(ell_spmm.ell_spmm_cuda(*args, z_view, quantise=quantise,
                                           window=sw.window))
        assert all(torch.equal(runs[0], x) for x in runs[1:])
    one = ops.ell_spmm(*args, z, payload_dtype="bfloat16", window=sw.window)
    assert torch.equal(one, _ell_prequantised(sw, z))


def _ell_prequantised(sw, z):
    """The two-launch bf16 round, z cast to bf16 first and the kernel fed
    the cast messages beside the f32 own rows, through ops.ell_spmm in f32:
    rows N.. of a 2N-row payload hold the cast z, and row i's slots point
    there (rows N.. themselves have no slots and no diagonal)."""
    n = sw.n
    idx = torch.cat([sw.ell_idx + n, torch.arange(
        n, 2 * n, dtype=torch.int32, device=z.device)[:, None].expand_as(
            sw.ell_idx)]).contiguous()
    val = torch.cat([sw.ell_val, torch.zeros_like(sw.ell_val)])
    diag = torch.cat([sw.diag, torch.zeros_like(sw.diag)])
    z2 = torch.cat([z, z.to(torch.bfloat16).float()])
    window = ell_spmm.window_plan(idx.cpu().numpy())
    return ops.ell_spmm(idx, val, diag, z2, window=window)[:n]


@pytest.mark.parametrize("payload", [None, "bfloat16"])
@pytest.mark.parametrize("k", [36, 35])
def test_ell_kernel_on_a_star(cuda_device, k, payload):
    """star(4096): the hub's 4095 slots do not fit shared memory beside any
    window, so the band's slots are read from device memory; within ELL's
    1e-6 of the plain version on the same quantised source, the same bits
    twice."""
    sw = SparseW.from_graph(topology.star(4096), payload_dtype=payload,
                            device=cuda_device)
    assert sw.ell_width == 4095
    p = ell_spmm.plan(4096, k, 4095, (sw.window.band_rows, sw.window.halo),
                      k % 4 == 0)
    assert not p.staged and p.smem <= ell_spmm.SMEM_LIMIT
    z = torch.randn((4096, k), device=cuda_device)
    got, again = sw.mix(z), sw.mix(z)
    z_src = z if payload is None else z.to(torch.bfloat16)
    want = ref.ell_spmm_ref(sw.ell_idx, sw.ell_val, sw.diag, z, z_src)
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= 1e-6 * float(
        want.abs().max()) + 1e-7


def test_ell_bits_do_not_depend_on_slot_staging(cuda_device):
    """A graph of ~600 slots a row: a band of 8 stages its slots beside the
    window, a band of 32 cannot and reads them from device memory; the same
    bits either way, in f32 and bf16, and within 1e-6 of the plain version
    evaluated in float64 on the same (quantised) source. z comes from a
    seeded generator, so every session reads the same inputs."""
    sw = SparseW.from_graph(topology.erdos_renyi(1024, 0.55, seed=1),
                            device=cuda_device)
    args = (sw.ell_idx, sw.ell_val, sw.diag)
    gen = torch.Generator(device=cuda_device).manual_seed(859)
    z = torch.randn((1024, 256), generator=gen, device=cuda_device)
    staged = [ell_spmm.plan(1024, 256, sw.ell_width, w, True).staged
              for w in ((8, 0), (32, 0))]
    assert staged == [True, False]
    for quantise in (False, True):
        a, b = (ell_spmm.ell_spmm_cuda(*args, z, quantise=quantise,
                                       window=ell_spmm.WindowPlan(*w, 0, 1))
                for w in ((8, 0), (32, 0)))
        assert torch.equal(a, b)
        z_src = z if not quantise else z.to(torch.bfloat16)
        want = _ell_plain_f64(*args, z, z_src)
        assert float((a.double() - want).abs().max()) <= 1e-6 * float(
            want.abs().max()) + 1e-7


def test_ell_wide_rows_hold_the_limit_over_many_payloads(cuda_device):
    """Rows of ~600 slots sum in partials of 32: against the float64 sum,
    every one of 50 seeded payloads stays within 1e-6 of max |out| (+1e-7),
    in f32 and bf16 and under both stagings. One chain of 608 FMAs broke
    that limit on ~12% of such payloads (tools/ell_error_sweep.py)."""
    sw = SparseW.from_graph(topology.erdos_renyi(1024, 0.55, seed=1),
                            device=cuda_device)
    args = (sw.ell_idx, sw.ell_val, sw.diag)
    for seed in range(50):
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        z = torch.randn((1024, 256), generator=gen, device=cuda_device)
        for quantise in (False, True):
            z_src = z.to(torch.bfloat16) if quantise else z
            want = _ell_plain_f64(*args, z, z_src)
            for w in ((8, 0), (32, 0)):
                got = ell_spmm.ell_spmm_cuda(
                    *args, z, quantise=quantise,
                    window=ell_spmm.WindowPlan(*w, 0, 1))
                assert float((got.double() - want).abs().max()) <= 1e-6 * \
                    float(want.abs().max()) + 1e-7, (seed, quantise, w)


def _ell_plain_f64(ell_idx, ell_val, diag, z_own, z_src):
    """The ELL round's plain version in float64: the slots scattered to a
    dense (N, N) matrix (padded slots add 0 on the diagonal)."""
    n = diag.shape[0]
    rows = torch.arange(n, device=ell_idx.device)[:, None].expand_as(ell_idx)
    w_off = torch.zeros((n, n), dtype=torch.float64, device=diag.device)
    w_off.index_put_((rows, ell_idx.long()), ell_val.double(),
                     accumulate=True)
    return diag.double()[:, None] * z_own.double() + w_off @ z_src.double()


def test_ell_bf16_round_is_one_launch(cuda_device):
    """A bf16-payload gossip run: one ELL launch a round, and no cast of
    the payload (no copy kernel beside it in the profile)."""
    from torch.profiler import ProfilerActivity, profile
    sw = _ell_graph("ws", 1024, cuda_device)
    bf = SparseW(sw.ell_idx, sw.ell_val, sw.diag, sw.row_nnz, sw.n,
                 sw.ell_width, "bfloat16", window=sw.window)
    z = torch.randn((1024, 3920), device=cuda_device)
    bf.mix(z)
    torch.cuda.synchronize()
    before = ops.LAUNCHES["ell_spmm"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            z = bf.mix(z)
        torch.cuda.synchronize()
    assert ops.LAUNCHES["ell_spmm"] == before + 3
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels and all("ell_spmm" in k for k in kernels), kernels


def _ws_stack(n, device, seeds=(1, 2, 3, 4)):
    """watts_strogatz(n, 6, 0.1) at several seeds, stacked: their ELL widths
    differ, so the narrower members are widened."""
    members = [SparseW.from_graph(topology.watts_strogatz(n, k=6, p=0.1,
                                                          seed=s),
                                  device=device) for s in seeds]
    assert len({m.ell_width for m in members}) > 1
    return members, SparseW.stack(members)


@pytest.mark.parametrize("payload", [None, "bfloat16"])
@pytest.mark.parametrize("k", [980, 35])
def test_batched_ell_kernel_matches_plain_and_single_launches(cuda_device,
                                                              k, payload):
    """A stack of four graphs is one launch a round; member k of it equals a
    single launch of ``st[k]`` (the widened member, its own window) bit for
    bit, and the whole lies within ELL's 1e-6 of the batched plain version
    on the same quantised source."""
    members, st = _ws_stack(1024, cuda_device)
    if payload is not None:
        st = st.with_payload_dtype(payload)
    z = torch.randn((len(members), 1024, k), device=cuda_device)
    before = ops.LAUNCHES["ell_spmm"]
    batched = ell_spmm.ROUTE_LAUNCHES["batched"]
    with no_host_sync():
        got = st.mix(z)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ell_spmm"] == before + 1
    assert ell_spmm.ROUTE_LAUNCHES["batched"] == batched + 1
    for m in range(len(members)):
        one = ops.ell_spmm(st.ell_idx[m], st.ell_val[m], st.diag[m], z[m],
                           payload_dtype=payload,
                           window=st.member_windows[m])
        assert torch.equal(got[m], one)
        assert st[m].window is st.member_windows[m]
    z_src = z if payload is None else z.to(torch.bfloat16)
    want = ref.ell_spmm_ref(st.ell_idx, st.ell_val, st.diag, z, z_src)
    assert float((got - want).abs().max()) <= 1e-6 * float(
        want.abs().max()) + 1e-7


def test_batched_ell_of_one_is_the_single_call(cuda_device):
    """A stack of one graph keeps the bits of today's single-matrix call."""
    sw = _ell_graph("ws", 1024, cuda_device)
    st = SparseW.stack([sw])
    z = torch.randn((1024, 3920), device=cuda_device)
    for payload in (None, "bfloat16"):
        one = ops.ell_spmm(sw.ell_idx, sw.ell_val, sw.diag, z,
                           payload_dtype=payload, window=sw.window)
        batched = ops.ell_spmm(st.ell_idx, st.ell_val, st.diag, z[None],
                               payload_dtype=payload, window=st.window)
        assert torch.equal(batched[0], one)


def test_batched_ell_refuses_what_it_does_not_take(cuda_device):
    """Mismatched batch or node axes, an f64 payload, int64 slots and a
    payload type other than f32 / bf16 raise; nothing falls back."""
    _, st = _ws_stack(256, cuda_device)
    z = torch.randn((4, 256, 8), device=cuda_device)
    args = (st.ell_idx, st.ell_val, st.diag)
    with pytest.raises(ValueError, match="align"):
        ell_spmm.ell_spmm_cuda(*args, z[:3], window=st.window)
    with pytest.raises(ValueError, match="align"):
        ell_spmm.ell_spmm_cuda(st.ell_idx[:, :128].contiguous(),
                               st.ell_val[:, :128].contiguous(),
                               st.diag[:, :128].contiguous(), z,
                               window=st.window)
    with pytest.raises(ValueError, match="dtype"):
        ell_spmm.ell_spmm_cuda(*args, z.double(), window=st.window)
    with pytest.raises(ValueError, match="dtype"):
        ell_spmm.ell_spmm_cuda(st.ell_idx.long(), st.ell_val, st.diag, z,
                               window=st.window)
    with pytest.raises(ValueError, match="dims"):
        ell_spmm.ell_spmm_cuda(*args, z[0], window=st.window)
    with pytest.raises(ValueError, match="payloads"):
        ops.ell_spmm(*args, z, payload_dtype="float16", window=st.window)


def test_fused_sparse_bdot_on_card_matches_cpu(cuda_device):
    """Fused B-DOT over stacked sparse row engines on the card: one ELL
    launch a round for the whole row stage, the CPU's trace within 1e-5."""
    x, _, _ = gaussian_eigengap_data(24, 2048, 3, 0.6, seed=0)
    grid = [partition_samples(sl, 256) for sl in partition_features(x, 2)]
    q_true = torch.linalg.eigh(x.double() @ x.double().T)[1][:, -3:].flip(
        -1).float()
    q_init = orthonormal_init(torch.Generator().manual_seed(0), 24, 3)
    runs = {}
    for dev in ("cpu", cuda_device):
        rows = [DenseConsensus(topology.watts_strogatz(256, k=6, p=0.1,
                                                       seed=s),
                               sparse=True, device=dev) for s in (1, 2)]
        cols = [DenseConsensus(topology.complete(2), device=dev)] * 256
        ops.reset_launches()
        runs[str(dev)] = bdot(
            blocks=[[b.to(dev) for b in row] for row in grid],
            col_engines=cols, row_engines=rows, r=3, t_outer=4, t_c=10,
            q_init=q_init.to(dev), q_true=q_true.to(dev), device=dev)
        launches = dict(ops.LAUNCHES)
    # 4 outer steps x 10 rounds, plus the two row tables' 10 rows each
    assert launches["ell_spmm"] == 4 * 10 + 2 * 10
    np.testing.assert_allclose(runs["cuda"].error_trace,
                               runs["cpu"].error_trace, atol=1e-5)


# ---------------------------------------------------------------------------
# straggler and network-fault gossip on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("payload", [None, "bfloat16"])
@pytest.mark.parametrize("kind", ["ws", "ring"])
def test_ell_kernel_under_faulty_round_operands(cuda_device, kind, payload):
    """A faulty round hands the ELL kernel per-round slot weights (masked
    at random, every slot of some rows), a zero diagonal and messages with
    rejected senders zeroed: within ELL's 1e-6 of the plain version, the
    fully masked rows exactly 0, one launch a round."""
    g = (topology.watts_strogatz(4096, k=6, p=0.1, seed=1) if kind == "ws"
         else topology.ring(4096))
    sw = SparseW.from_graph(g, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    zero = torch.zeros_like(sw.diag)
    for _ in range(4):
        z = torch.randn((4096, 3920), generator=gen, device=cuda_device)
        z[torch.rand(4096, generator=gen, device=cuda_device) < 0.05] = 0.0
        keep = torch.rand(sw.ell_val.shape, generator=gen,
                          device=cuda_device) < 0.6
        keep[:100] = False
        val = torch.where(keep, sw.ell_val, 0.0)
        before = ops.LAUNCHES["ell_spmm"]
        got = ops.ell_spmm(sw.ell_idx, val, zero, z, payload_dtype=payload,
                           window=sw.window)
        assert ops.LAUNCHES["ell_spmm"] == before + 1
        z_src = z if payload is None else z.to(torch.bfloat16)
        want = ref.ell_spmm_ref(sw.ell_idx, val, zero, z, z_src)
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max()) + 1e-7
        assert bool((got[:100] == 0).all())


def _fault_inputs(n, t, seed):
    from repro_torch.core.netfaults import sample_fault_blocks
    return sample_fault_blocks(torch.Generator().manual_seed(seed), n, t)


@pytest.mark.parametrize("mode", ["scale", "nan"])
def test_faulty_dense_round_on_card_matches_cpu(cuda_device, mode):
    """A dense faulty engine on the card and on the CPU, fed the same
    draws: the same masks (burst state, sends, up counts) and the mixed
    stack within 1e-5."""
    from repro_torch.core.metrics import CommLedger
    from repro_torch.core.netfaults import FaultyConsensus, NetFaultModel
    g = topology.erdos_renyi(20, 0.25, seed=1)
    model = NetFaultModel(p_drop=0.2, p_bad=0.05, p_good=0.5, p_corrupt=0.1,
                          corrupt_mode=mode)
    z = torch.randn((20, 1024, 7), generator=torch.Generator().manual_seed(1))
    node_up = np.ones(20, np.float32)
    node_up[0] = 0.0
    out, ge, ledgers = {}, {}, {}
    for dev in ("cpu", "cuda"):
        eng = FaultyConsensus(g, model, seed=7, device=dev)
        ledgers[dev] = CommLedger()
        for call in range(3):
            out[dev] = eng.run_debiased(z.to(dev), 50, ledgers[dev],
                                        faults=_fault_inputs(20, 50, call),
                                        node_up=node_up)
        ge[dev] = eng._ge.cpu()
    assert torch.equal(ge["cpu"], ge["cuda"])
    assert ledgers["cpu"] == ledgers["cuda"]
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=1e-5,
                               atol=1e-5)


def test_sparse_faulty_round_on_card_matches_cpu(cuda_device):
    """The ELL faulty rounds (watts_strogatz(4096), one ELL launch a round)
    on the card against the CPU on the same slot-form draws, f32 and bf16
    messages: the same masks (burst state, sends, up counts) and the
    realized column within 1e-5; the mixed stack within 1e-5 in f32. With
    bf16 messages the two sides round the same f32 values alike, but those
    differ in their last bits, so a message near a rounding boundary can
    land one bf16 ulp (2^-8 of it) apart in a round: 20 rounds, at most
    20 x 2^-8 of max |z|. (The debiased output is not compared: at the
    edge of the realized product's reach, 20 rounds from node 0, it
    divides by values near the 1e-6 clamp.)"""
    from repro_torch.core.netfaults import (FaultyConsensus, NetFaultModel,
                                            masked_faulty_rounds)
    g = topology.watts_strogatz(4096, k=6, p=0.1, seed=1)
    model = NetFaultModel(p_drop=0.2, p_bad=0.05, p_good=0.5)
    z = torch.randn((4096, 784, 5), generator=torch.Generator().manual_seed(2))
    node_up = torch.ones(4096)
    node_up[7] = 0.0
    for payload in (None, "bfloat16"):
        draws = FaultyConsensus(g, model, seed=7, device="cpu")._draw(0, 20)
        out = {}
        for dev in ("cpu", "cuda"):
            eng = FaultyConsensus(g, model, seed=7, payload_dtype=payload,
                                  device=dev)
            assert eng.is_sparse
            before = ops.LAUNCHES["ell_spmm"]
            out[dev] = masked_faulty_rounds(
                eng._w, eng._adj, eng._params, node_up.to(dev), eng._ge,
                eng._prepare(draws), 20, z.to(dev))
            if dev == "cuda":
                assert ops.LAUNCHES["ell_spmm"] == before + 20
        (z_c, p_c, ge_c, s_c, n_c), (z_g, p_g, ge_g, s_g, n_g) = (
            out["cpu"], [t.cpu() for t in out["cuda"]])
        assert torch.equal(ge_c, ge_g) and torch.equal(s_c, s_g)
        assert torch.equal(n_c, n_g)
        if payload is None:
            torch.testing.assert_close(z_g, z_c, rtol=1e-5, atol=1e-5)
        else:
            assert float((z_g - z_c).abs().max()) <= 20 * 2.0 ** -8 * float(
                z_c.abs().max())
        torch.testing.assert_close(p_g, p_c, rtol=1e-5, atol=1e-7)


def test_async_round_on_card_matches_cpu(cuda_device):
    from repro_torch.core.async_gossip import AsyncConsensus
    from repro_torch.core.metrics import CommLedger
    g = topology.erdos_renyi(20, 0.25, seed=1)
    p_awake = np.full(20, 0.8)
    p_awake[0] = 1 / 11
    awake = torch.rand((50, 20), generator=torch.Generator().manual_seed(4))
    awake = awake < torch.as_tensor(p_awake, dtype=torch.float32)
    z = torch.randn((20, 1024, 7), generator=torch.Generator().manual_seed(5))
    out, ledgers = {}, {}
    for dev in ("cpu", "cuda"):
        ledgers[dev] = CommLedger()
        out[dev] = AsyncConsensus(g, p_awake, device=dev).run_debiased(
            z.to(dev), 50, ledgers[dev], awake=awake)
    assert ledgers["cpu"] == ledgers["cuda"]
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["async", "faulty"])
def test_async_and_faulty_sdot_on_card_match_cpu(cuda_device, kind):
    """S-DOT over async and faulty engines on the card against the CPU on
    the same injected draws; on the card the fused run equals the eager
    one bit for bit, and its loop never waits for the device."""
    from repro_torch.core.async_gossip import AsyncConsensus
    from repro_torch.core.netfaults import FaultyConsensus, NetFaultModel
    d, r, n, t_outer, t_c = 48, 4, 10, 12, 30
    g = topology.erdos_renyi(n, 0.5, seed=1)
    model = NetFaultModel(p_drop=0.2, p_bad=0.05, p_good=0.5, p_corrupt=0.05,
                          corrupt_mode="nan", crash_windows=((0, 3, 3),))

    def engine(dev):
        return (AsyncConsensus(g, 0.7, seed=3, device=dev) if kind == "async"
                else FaultyConsensus(g, model, seed=3, device=dev))

    draws = [engine("cpu")._draw(k, t_c) for k in range(t_outer)]
    runs = {}
    for dev in ("cpu", "cuda"):
        x, _, _ = gaussian_eigengap_data(d, n * 300, r, 0.7, seed=0,
                                         device=dev)
        blocks = partition_samples(x, n)
        m = sum(b @ b.T / b.shape[1] for b in blocks)
        kw = dict(data=blocks, r=r, t_outer=t_outer, t_c=t_c,
                  q_init=orthonormal_init(torch.Generator().manual_seed(0),
                                          d, r, device=dev),
                  q_true=torch.linalg.eigh(m)[1][:, -r:], device=dev,
                  draws=draws)
        runs[dev] = sdot(engine=engine(dev), **kw)
        if dev == "cuda":
            eager = sdot(engine=engine(dev), fused=False, **kw)
            assert torch.equal(runs[dev].q_nodes, eager.q_nodes)
            np.testing.assert_array_equal(runs[dev].error_trace,
                                          eager.error_trace)
            assert runs[dev].ledger == eager.ledger
            # the engine's own draws, made on the card, and no error trace
            # (its SVDs wait for the device): no host sync
            from repro_torch.core import runtime
            from repro_torch.core.sdot import sdot_program
            prog = sdot_program(engine=engine(dev),
                                **dict(kw, draws=None, q_true=None))
            prog.finalize = None
            with no_host_sync():
                runtime.run_monolithic(prog)
    np.testing.assert_allclose(runs["cuda"].error_trace,
                               runs["cpu"].error_trace, rtol=0, atol=1e-5)
    assert runs["cuda"].ledger == runs["cpu"].ledger


@pytest.mark.parametrize("kind,lanes,nodes,d,n", [
    ("gram_apply", 12, 20, 1024, 2500),     # sdot_dense's shape
    ("slab_tq", 12, 4, 200, 300),            # 9 + 3: a ragged last group
    ("slab_tq", 4, 20, 55, 50000),           # fdot_dense's shape
    ("slab_apply", 4, 20, 55, 50000),
    ("slab_apply", 3, 6, 17, 1001),          # n % 4 != 0: the cp.async route
])
def test_lane_dispatch_matches_one_launch_a_lane_and_plain(cuda_device,
                                                           kind, lanes,
                                                           nodes, d, n):
    """Each lane dispatch at r = 7 against the batched wrapper over one
    lane at a time and the plain version: the slab tq kernel folds
    ``lane_fold_width`` lanes a launch, within 1e-5 of the plain version's
    max of both (f32 sums in another order); gram-apply and slab apply
    launch once a lane, with the batched wrapper's bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    r = 7
    x = torch.randn((nodes, d, n), generator=gen, device=cuda_device)
    if kind == "gram_apply":
        n_true = torch.full((nodes,), float(n), device=cuda_device)
        y = torch.randn((lanes, nodes, d, r), generator=gen,
                        device=cuda_device)
        run = lambda: ops.lane_gram_apply(x, y, n_true)  # noqa: E731
        one = lambda q: ops.batched_gram_apply(x, q, n_true)  # noqa: E731
        plain = torch.stack([ref.batched_gram_apply_ref(x, q, n_true)
                             for q in y])
        per_launch = 1
    elif kind == "slab_tq":
        y = torch.randn((lanes, nodes, d, r), generator=gen,
                        device=cuda_device)
        run = lambda: ops.lane_slab_tq(x, y)  # noqa: E731
        one = lambda q: ops.batched_slab_tq(x, q)  # noqa: E731
        plain = torch.stack([ref.batched_slab_tq_ref(x, q) for q in y])
        per_launch = ops.lane_fold_width(lanes, r)
    else:
        y = torch.randn((lanes, nodes, n, r), generator=gen,
                        device=cuda_device)
        run = lambda: ops.lane_slab_apply(x, y)  # noqa: E731
        one = lambda s: ops.batched_slab_apply(x, s)  # noqa: E731
        plain = torch.stack([ref.batched_slab_apply_ref(x, s) for s in y])
        per_launch = 1
    counter = {"gram_apply": "batched_gram_apply",
               "slab_tq": "batched_slab_tq",
               "slab_apply": "batched_slab_apply"}[kind]
    ops.reset_launches()
    got = run()
    assert ops.LAUNCHES[counter] == -(-lanes // per_launch)
    each = torch.stack([one(lane) for lane in y])
    if per_launch == 1:
        assert torch.equal(got, each)
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 1e-5 * scale
    assert float((each - plain).abs().max()) <= 1e-5 * scale


def test_gram_qr_takes_every_lane_in_one_launch(cuda_device):
    """(lanes, N, d, r) is one Gram launch, each matrix's bits those of a
    launch over its own lane."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    v = torch.randn((3, 4, 20, 1024, 7), generator=gen, device=cuda_device)
    ops.reset_launches()
    g = ops.gram_qr(v)
    assert ops.LAUNCHES["gram_qr"] == 1 and g.shape == (3, 4, 20, 7, 7)
    assert torch.equal(g[1, 2], ops.gram_qr(v[1, 2]))
    want = ref.gram_qr_ref(v)
    assert float((g - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _small_psa(cuda_device, n_nodes=8, d=48, r=4):
    x, _, _ = gaussian_eigengap_data(d, 200 * n_nodes, r, 0.7, seed=0,
                                     device=cuda_device)
    blocks = partition_samples(x, n_nodes)
    covs = torch.stack([b @ b.T / b.shape[1] for b in blocks])
    q_true = torch.linalg.eigh(covs.sum(0).double())[1][:, -r:].float()
    eng = DenseConsensus(topology.erdos_renyi(n_nodes, 0.5, seed=1),
                         device=cuda_device)
    return x, blocks, covs, q_true, eng


@pytest.mark.parametrize("name", ["seq_dist_pm", "dsa", "dpgd", "deepca",
                                  "d_pm"])
def test_baselines_smoke_on_card(cuda_device, name):
    """Each distributed baseline fused on the card: finite, its ledger the
    eager run's, its trace within 1e-4 of the eager run's (the fused run
    debiases by the device table, the eager one by the host's matrix
    power), DPGD and DeEPCA with two Gram launches a step, no host sync
    inside the fused loop's steps."""
    from repro_torch.core import baselines
    from repro_torch.core.metrics import CommLedger
    x, blocks, covs, q_true, eng = _small_psa(cuda_device)
    data = partition_features(x, 8) if name == "d_pm" else covs
    kw = (dict(iters_per_vec=5, t_c=20) if name in ("seq_dist_pm", "d_pm")
          else dict(t_outer=12))
    led_f, led_e = CommLedger(), CommLedger()
    ops.reset_launches()
    q_f, e_f = getattr(baselines, name)(data, eng, 4, q_true=q_true,
                                        ledger=led_f, device=cuda_device,
                                        **kw)
    launches = ops.LAUNCHES["gram_qr"]
    q_e, e_e = getattr(baselines, name)(data, eng, 4, q_true=q_true,
                                        ledger=led_e, fused=False,
                                        device=cuda_device, **kw)
    assert np.isfinite(e_f).all() and bool(torch.isfinite(q_f).all())
    assert float(np.abs(e_f - e_e).max()) <= 1e-4
    assert led_f == led_e
    if name in ("dpgd", "deepca"):
        assert launches == 2 * len(e_f)


def test_sweeps_smoke_on_card(cuda_device, tmp_path):
    """An S-DOT sweep in data mode (two cases, const and lin2, x three
    seeds): each lane within 1e-5 of its single run on the card, one
    gram-apply launch a lane a step, two Gram launches a step for every
    lane; killed after 2 chunks and resumed, bit for bit."""
    from repro_torch.core import sweep
    x, blocks, covs, q_true, eng = _small_psa(cuda_device)
    scheds = [consensus_schedule("const", 8, t_max=20),
              consensus_schedule("lin2", 8, cap=20)]
    kw = dict(data=blocks, engines=eng, schedules=scheds, r=4, t_outer=8,
              seeds=[0, 1, 2], q_true=q_true)
    ops.reset_launches()
    sw = sweep.sdot_sweep(**kw)
    assert ops.LAUNCHES["batched_gram_apply"] == 8 * 6
    assert ops.LAUNCHES["gram_qr"] == 2 * 8
    for ci, sched in enumerate(scheds):
        for si, s in enumerate([0, 1, 2]):
            res = sdot(data=blocks, engine=eng, r=4, t_outer=8,
                       schedule=sched, q_true=q_true, device=cuda_device,
                       generator=torch.Generator().manual_seed(s))
            assert float(np.abs(sw.error_traces[ci, si]
                                - res.error_trace).max()) <= 1e-5
    mgr = CheckpointManager(str(tmp_path))
    sweep.sdot_sweep(manager=mgr, chunk_size=3, max_chunks=2, **kw)
    res = sweep.sdot_sweep(manager=mgr, chunk_size=3, **kw)
    assert res.resumed_step == 6
    assert np.array_equal(res.error_traces, sw.error_traces)
    assert torch.equal(res.q, sw.q)


# ---------------------------------------------------------------------------
# streaming ingest and the serving loop on the card
# ---------------------------------------------------------------------------
FULL_SERVICE = dict(d=1024, r=7, n_nodes=20, batch_size=2000, gap=0.7,
                    lead=3.0, shift_lead=6.0, shift_at=8, t_outer=100,
                    t_c=50, resolve_chunk=10, chunks_per_tick=2,
                    topology={"kind": "er", "n": 20, "p": 0.25, "seed": 1})


def test_stream_is_stateless_on_card(cuda_device):
    """A CIFAR-10-width drifting stream drawn on the card: the same (seed,
    step) gives the same bits from another stream object and in another
    order, steps differ, and the batch never leaves the card."""
    fn, _, _ = drifting_eigengap_stream(1024, 7, 0.7, 8, seed=0,
                                        device=cuda_device)
    fn2, _, _ = drifting_eigengap_stream(1024, 7, 0.7, 8, seed=0,
                                         device=cuda_device)
    late = fn(9, 2000)
    early = fn(3, 2000)
    assert early.is_cuda and early.shape == (1024, 2000)
    assert torch.equal(early, fn2(3, 2000)) and torch.equal(late, fn2(9, 2000))
    assert not torch.equal(early, fn(4, 2000))


def test_exact_sketch_on_card_matches_float64(cuda_device):
    """10 micro-batches of 2,000 over 20 nodes into the exact sketch: within
    1e-5 (relative to its max) of a float64 sum of the same per-node
    blocks; the Ritz track's values interlace the global covariance's
    eigenvalues from below (one subspace iteration a batch: a lagging
    track, never an overshoot) and its top value is within 1e-3 of the
    top eigenvalue."""
    fn, _, _ = drifting_eigengap_stream(1024, 7, 0.7, 8, seed=0,
                                        device=cuda_device)
    ing = StreamingIngestor(n_nodes=20, d=1024, batch_fn=fn,
                            batch_size=2000, track_top=7,
                            device=cuda_device).ingest(10)
    sm64 = torch.zeros((20, 1024, 1024), dtype=torch.float64,
                       device=cuda_device)
    for t in range(10):
        blocks = torch.stack(partition_samples(fn(t, 2000), 20)).double()
        sm64 += blocks @ blocks.mT
    want = sm64 / 1000.0
    got = ing.cov_stack().double()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    vals = torch.linalg.eigvalsh(sm64.sum(0) / 20000.0).flip(0)[:8].cpu()
    ritz = torch.as_tensor(ing.ritz_values).double()
    assert bool((ritz <= vals * (1 + 1e-5)).all()), (ritz, vals)
    assert float(abs(ritz[0] - vals[0])) <= 1e-3 * float(vals[0])


def test_frequent_directions_bound_on_card(cuda_device):
    """FD at d = 1024, ell = 128 over 4 batches of 100 samples a node:
    ||X X^T - B^T B||_2 <= shrink_loss on every node (float64 check)."""
    fn, _, _ = drifting_eigengap_stream(1024, 7, 0.7, 8, seed=0,
                                        device=cuda_device)
    fd = StreamingIngestor(n_nodes=4, d=1024, batch_fn=fn, batch_size=400,
                           sketch="fd", ell=128,
                           device=cuda_device).ingest(4)
    xs = [torch.stack(partition_samples(fn(t, 400), 4)).double()
          for t in range(4)]
    b = fd.sketch.sketch.double()
    loss = fd.sketch.shrink_loss
    assert bool((loss > 0).all())
    for i in range(4):
        xx = sum(x[i] @ x[i].T for x in xs)
        gap = float(torch.linalg.matrix_norm(xx - b[i].T @ b[i], ord=2))
        assert gap <= float(loss[i]) * (1 + 1e-4) + 1e-4


def test_full_width_service_resumes_bitwise_on_card(cuda_device, tmp_path):
    """The CIFAR-10-width service for 8 ticks (the initial cold solve swaps
    at tick 6): stopped after tick 4 and resumed by a fresh service, the
    same served bits and swap ticks as the uninterrupted run; the Gram
    kernel runs every CholeskyQR2 of the re-solve and the candidate's."""
    cfg = ServiceConfig(**FULL_SERVICE, total_ticks=8)
    ops.reset_launches()
    ref = PSAService(cfg, str(tmp_path / "ref"), device=cuda_device).run()
    ref.finalize()
    assert ops.LAUNCHES["gram_qr"] == 2 * cfg.t_outer + 2
    want = service_summary(str(tmp_path / "ref"))
    PSAService(cfg, str(tmp_path / "res"), device=cuda_device).run(until=4)
    PSAService(cfg, str(tmp_path / "res"), device=cuda_device).run(
    ).finalize()
    got = service_summary(str(tmp_path / "res"))
    assert want["swap_ticks"] == [6] and want["gate_rejects"] == 0
    assert got["served_sha256"] == want["served_sha256"]
    assert got["swap_ticks"] == want["swap_ticks"]
    assert [e["tick"] for e in got["restores"]] == [3]


def test_query_path_reads_the_card_copy_swapped_whole(cuda_device, tmp_path):
    """At a swap the host and card copies of the served subspace are
    replaced by one assignment: before and after, the card copy is the host
    copy's bits, on the card, and queries answer against it."""
    cfg = ServiceConfig(d=64, r=4, n_nodes=4, batch_size=64, total_ticks=9,
                        t_outer=12, t_c=12, resolve_chunk=3,
                        chunks_per_tick=2, warmup_ticks=1)
    svc = PSAService(cfg, str(tmp_path), device=cuda_device)
    seen = []
    while svc.tick + 1 < cfg.total_ticks:
        before = svc.served
        svc.run(until=svc.tick + 2)
        after = svc.served
        for s in (before, after):
            assert s.device.is_cuda
            assert torch.equal(s.device.cpu(), torch.from_numpy(s.host))
        if after is not before:
            seen.append(svc.tick)
            assert not np.array_equal(after.host, before.host)
    assert seen and svc.swaps >= 1
    qp = QueryPath(device=cuda_device)
    x = np.random.default_rng(0).standard_normal(cfg.d)
    qp.submit(0, x)
    got = qp.process(svc.served.device)[0][1]
    np.testing.assert_allclose(got, svc.served.host.T @ x, rtol=1e-5,
                               atol=1e-5)


def _sdot_spmd_rank(rank, world, dev, covs, q_init, q_true, sched):
    from repro_torch.core.consensus import SpmdConsensus
    from repro_torch.core.sdot import sdot_spmd
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(device=dev)
    engine = SpmdConsensus(mesh, "nodes", graph=topology.ring(world))
    ops.reset_launches()
    res = sdot_spmd(covs=covs[rank], engine=engine, r=q_init.shape[1],
                    t_outer=len(sched), schedule=sched, q_init=q_init,
                    q_true=q_true)
    return {"q": res.q_nodes.cpu(), "trace": res.error_trace,
            "gram_qr": ops.LAUNCHES["gram_qr"],
            "staged": engine.host_staged_bytes}


def test_sdot_spmd_two_ranks_on_card_match_dense_engine(cuda_device):
    """Two gloo ranks sharing the card, each holding its own cov block,
    against the fused S-DOT over a DenseConsensus on the card: trace, every
    node's estimate, two Gram launches a step on each rank, and the exact
    bytes staged through pinned host memory."""
    from repro_torch.launch.mesh import spawn_ranks

    d, r, n, t_outer = 64, 3, 2, 10
    x, _, _ = gaussian_eigengap_data(d, n * 500, r, 0.7, seed=0,
                                     device=cuda_device)
    covs = torch.stack([b @ b.T / b.shape[1]
                        for b in partition_samples(x, n)])
    q_true = torch.linalg.eigh(covs.sum(0).double())[1][:, -r:].float()
    q_init = orthonormal_init(torch.Generator().manual_seed(1), d, r)
    sched = consensus_schedule("lin2", t_outer, cap=8)
    want = sdot(covs=covs, engine=DenseConsensus(topology.ring(n),
                                                 device=cuda_device),
                r=r, t_outer=t_outer, schedule=sched, q_init=q_init,
                q_true=q_true, device=cuda_device)
    res = spawn_ranks(_sdot_spmd_rank, n, backend="gloo", device="cuda",
                      args=(covs.cpu(), q_init, q_true.cpu(), sched))
    # each round stages its exchange: z down, the one neighbour's block
    # back; then the trace's all-reduce and the final gather
    payload = d * r * 4
    staged = (2 * payload * int(sched.sum()) + 2 * 4 * t_outer
              + payload * (1 + n))
    for out in res:
        np.testing.assert_allclose(out["trace"], want.error_trace,
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(out["q"].numpy(),
                                   want.q_nodes.cpu().numpy(), rtol=0,
                                   atol=1e-5)
        assert out["gram_qr"] == 2 * t_outer
        assert out["staged"] == staged


def _psa_step_rank(rank, world, dev, batch):
    from repro_torch.configs.base import PSAConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.psa_compress import psa_init
    from repro_torch.train.step import make_psa_train_step, shard_batch

    cfg = reduced_config(get_arch("qwen2-7b"))
    pod = make_test_mesh(multi_pod=True, device=dev).axis("pod")
    params = tree_map(lambda t: t.to(dev), init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    psa = PSAConfig(rank=4, oi_iters=2, gossip_rounds=2)
    opt = AdamWConfig(warmup_steps=1)
    psa_state = psa_init(params, psa)
    step, refresh = make_psa_train_step(cfg, opt, psa, group=pod)
    local = shard_batch({k: v.to(dev) for k, v in batch.items()}, pod.index,
                        pod.size)
    ops.reset_launches()
    psa_state = refresh(params, psa_state, local)
    refresh_launches = ops.LAUNCHES["gram_qr"]
    params, _, psa_state, met = step(params, adamw_init(params, opt),
                                     psa_state, local)
    return {"loss": float(met["loss"]), "gnorm": float(met["grad_norm"]),
            "params": tree_map(lambda t: t.cpu(), params),
            "proj": {k: v for k, v in
                     _flat_leaves(psa_state["proj"]).items()},
            "refresh_launches": refresh_launches}


def _flat_leaves(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_leaves(v, f"{prefix}/{k}"))
    elif tree is not None:
        out[prefix] = tree.cpu()
    return out


def test_psa_train_step_two_ranks_on_card_matches_cpu(cuda_device):
    """A refresh and one PSA step on 2 pod ranks sharing the card, reduced
    qwen2-7b (f32), against the same on 2 CPU ranks: the pod-mean loss, the
    grad norm, the parameters (to 1e-4 of the largest), orthonormal
    projectors, and three Gram launches (shifted CholeskyQR3) a compressed
    leaf an OI iteration."""
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.optim.psa_compress import CQR_PASSES

    cfg = reduced_config(get_arch("qwen2-7b"))
    batch = make_lm_batch(cfg, 0, 0, 4, 8, device="cpu")
    card = spawn_ranks(_psa_step_rank, 2, device="cuda", args=(batch,))
    cpu = spawn_ranks(_psa_step_rank, 2, device="cpu", args=(batch,))
    n_leaves = len(card[0]["proj"])
    assert n_leaves >= 5
    for got, want in zip(card, cpu):
        assert np.isfinite(got["loss"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-4)
        a, b = _flat_leaves(got["params"]), _flat_leaves(want["params"])
        top = max(float(v.abs().max()) for v in b.values())
        for k in b:
            assert float((a[k] - b[k]).abs().max()) <= 1e-4 * top, k
        for p in got["proj"].values():
            gram = p.mT @ p
            torch.testing.assert_close(
                gram, torch.eye(p.shape[-1]).expand_as(gram), atol=1e-4,
                rtol=0)
        assert got["refresh_launches"] == CQR_PASSES * 2 * n_leaves


def test_zz_forward_after_the_other_card_tests(cuda_device):
    """Last in the file: the f32 forward of
    test_forward_on_card_matches_cpu, repeated 50 times in the process that
    ran every card test before it, each within that test's limit (1e-4 +
    1e-4 |cpu|). Prints the readings (run with -s to see them)."""
    cfg, params, toks, cpu_params, cpu_toks = _lm_setup(cuda_device)
    with torch.inference_mode():
        want = forward(cpu_params, {"tokens": cpu_toks}, cfg)
        readings, first, same, fails = [], None, 0, 0
        for _ in range(50):
            got = forward(params, {"tokens": toks}, cfg).cpu()
            diff = (got - want).abs()
            readings.append(float(diff.max()))
            fails += bool((diff > 1e-4 + 1e-4 * want.abs()).any())
            first = got if first is None else first
            same += bool(torch.equal(got, first))
    print(f"forward_after_card_tests: max |diff| min {min(readings)} "
          f"max {max(readings)}; outside the limit {fails}; logits equal "
          f"to run 0 in {same} of {len(readings)}")
    assert fails == 0
