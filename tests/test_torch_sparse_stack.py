"""Stacked sparse engines, the batched ELL round and the sparse paths of the
baselines, B-DOT and the chunked runtime: the port against the JAX reference
on the CPU (twins of ``tests/test_sparse.py``'s ``test_stack_and_getitem``,
``test_baselines_sparse_vs_dense_fused_and_eager``,
``test_bdot_sparse_stacked_engines``, ``test_sweep_rejects_sparse_engines``
and ``test_sparse_run_chunked_resume_bit_identical``).

Both packages get the same NumPy inputs and graph; where the reference
draws an init, the port is handed it (``q_init``). Tolerances:

* a member of a stack against the matrix it came from: bitwise (the same
  slots in the same order; the widened slots add 0);
* the batched plain ELL round against the reference's vmapped one: 1e-6
  (f32 gathers summed in another order);
* sparse engine against dense engine, and the port against the reference:
  the reference's own 1e-5 on q and on the trace, and a principal angle of
  at most 1e-5 for B-DOT;
* a chunked run killed and resumed against the uninterrupted one: bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import topology as jtopo
from repro.core.bdot import bdot as j_bdot
from repro.core.consensus import DenseConsensus as JDense
from repro.core.consensus import SparseConsensus as JSparse
from repro.core.linalg import orthonormal_init as j_init
from repro.core.runtime import run_monolithic as j_run_monolithic
from repro.core.sdot import sdot_program as j_sdot_program
from repro.core.sparse import SparseW as JSparseW
from repro.kernels.ops import ell_spmm as j_ell_spmm
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import baselines as tb
from repro_torch.core.bdot import bdot
from repro_torch.core.consensus import (DenseConsensus, SparseConsensus,
                                        debiased_gossip, gossip_mix)
from repro_torch.core.runtime import run_chunked, run_monolithic
from repro_torch.core.sdot import sdot_program
from repro_torch.core.sparse import SparseW
from repro_torch.core.sweep import sdot_sweep
from repro_torch.core.topology import Graph
from repro_torch.kernels import ell_spmm as ell_mod
from repro_torch.kernels import ref

TOL = 1e-5


def t32(a):
    return torch.tensor(np.asarray(a, np.float32))


def _principal_angle_f64(q1, q2):
    a = np.linalg.qr(np.asarray(q1, np.float64))[0]
    b = np.linalg.qr(np.asarray(q2, np.float64))[0]
    s = np.linalg.svd(a.T @ b, compute_uv=False)
    return float(np.arccos(np.clip(s, -1.0, 1.0)).max())


def _pair(jgraph, sparse=True):
    """The reference engine and the port's over the same graph."""
    g = Graph(jgraph.adjacency)
    if sparse:
        return JSparse(jgraph), SparseConsensus(g, device="cpu")
    return (JDense(jgraph, sparse=False),
            DenseConsensus(g, sparse=False, device="cpu"))


@pytest.fixture(scope="module")
def psa():
    """The reference's ``_psa_problem``: watts_strogatz(20, 4, 0.2, seed 1),
    d = 12, r = 3, 30 samples a node."""
    g = jtopo.watts_strogatz(20, k=4, p=0.2, seed=1)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((20, 12, 30)).astype(np.float32)
    covs = np.einsum("nds,nes->nde", x, x) / 30.0
    q_true = np.linalg.eigh(covs.mean(0))[1][:, ::-1][:, :3].copy()
    return dict(g=g, covs=covs, q_true=q_true, r=3,
                q_init=t32(j_init(jax.random.PRNGKey(0), 12, 3)))


# ---------------------------------------------------------------------------
# SparseW.stack, indexing, dtype, payload dtype
# ---------------------------------------------------------------------------
def _ring_er():
    j1, j2 = jtopo.ring(10), jtopo.erdos_renyi(10, 0.4, seed=1)
    t1, t2 = (SparseW.from_graph(Graph(g.adjacency), device="cpu")
              for g in (j1, j2))
    return (JSparseW.from_graph(j1), JSparseW.from_graph(j2)), (t1, t2)


def test_stack_and_getitem():
    (j1, j2), (t1, t2) = _ring_er()
    assert t1.ell_width != t2.ell_width            # the widening path
    st, jst = SparseW.stack([t1, t2]), JSparseW.stack([j1, j2])
    assert st.batch == 2 and st.ell_width == jst.ell_width
    np.testing.assert_array_equal(st.ell_idx.numpy(), np.asarray(jst.ell_idx))
    np.testing.assert_array_equal(st.ell_val.numpy(), np.asarray(jst.ell_val))
    z = np.random.default_rng(1).standard_normal((10, 4)).astype(np.float32)
    for k, s in enumerate((t1, t2)):
        assert torch.equal(st[k].mix(t32(z)), s.mix(t32(z)))
        np.testing.assert_allclose(st[k].mix(t32(z)).numpy(),
                                   np.asarray(jst[k].mix(jnp.asarray(z))),
                                   atol=1e-6)
    assert st.dtype == torch.float32
    assert st.astype(torch.float64).dtype == torch.float64
    bf = st.with_payload_dtype("bfloat16")
    assert bf.payload_dtype == "bfloat16" and st.payload_dtype is None
    with pytest.raises(ValueError, match="matching"):
        SparseW.stack([t1, SparseW.from_graph(Graph(jtopo.ring(12).adjacency),
                                              device="cpu")])
    with pytest.raises(ValueError, match="matching"):
        SparseW.stack([t1, t2.with_payload_dtype("bfloat16")])
    with pytest.raises(TypeError):
        t1[0]


def test_stacked_mix_matches_vmapped_reference():
    """A (B, N, ...) payload through the stack against the reference's
    vmapped mix of its stack, in f32 and with bf16 messages."""
    (j1, j2), (t1, t2) = _ring_er()
    z = np.random.default_rng(2).standard_normal((2, 10, 3, 2)) \
        .astype(np.float32)
    for payload in (None, "bfloat16"):
        st = SparseW.stack([t1, t2]).with_payload_dtype(payload)
        jst = JSparseW.stack([j1, j2]).with_payload_dtype(payload)
        got = st.mix(t32(z))
        want = jax.vmap(lambda w, x: w.mix(x))(jst, jnp.asarray(z))
        assert got.shape == z.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("form", ["gather", "dense", "scan"])
def test_batched_plain_ell_matches_reference_vmap(form):
    """The plain version's batch axis, each of its three forms, against the
    reference's ``ell_spmm`` vmapped over a stack of ragged graphs widened
    to one L; bf16 messages too."""
    graphs = [jtopo.watts_strogatz(32, k=4, p=0.3, seed=s) for s in (1, 2, 3)]
    jst = JSparseW.stack([JSparseW.from_graph(g) for g in graphs])
    idx, val, diag = (np.asarray(a) for a in (jst.ell_idx, jst.ell_val,
                                              jst.diag))
    z = np.random.default_rng(3).standard_normal((3, 32, 5)) \
        .astype(np.float32)
    fn = {"gather": ref.ell_spmm_ref, "dense": ref.ell_spmm_dense_ref,
          "scan": ref.ell_spmm_scan_ref}[form]
    for payload in (None, "bfloat16"):
        want = jax.vmap(lambda i, v, d, x: j_ell_spmm(
            i, v, d, x, payload_dtype=payload, use_pallas=False))(
                jnp.asarray(idx), jnp.asarray(val), jnp.asarray(diag),
                jnp.asarray(z))
        zt = t32(z)
        src = zt if payload is None else zt.to(torch.bfloat16)
        got = fn(torch.tensor(idx), t32(val), t32(diag), zt, src)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        for k in range(3):        # a member of the batch is its own round
            one = fn(torch.tensor(idx[k]), t32(val[k]), t32(diag[k]), zt[k],
                     src[k])
            np.testing.assert_allclose(got[k].numpy(), one.numpy(),
                                       atol=1e-6)


def test_getitem_and_astype_hand_on_window_plans(monkeypatch):
    """``stack`` plans the batched launch's window from every member's host
    indices and each member's own; indexing, ``astype`` and
    ``with_payload_dtype`` hand them on without planning again (a plan
    copies the indices to the host, which on the card waits for it)."""
    (_, _), (t1, t2) = _ring_er()
    st = SparseW.stack([t1, t2])
    assert st.window == ell_mod.window_plan(st.ell_idx.numpy())
    assert st.member_windows[0] == ell_mod.window_plan(st.ell_idx[0].numpy())
    assert st.member_windows[1] is t2.window    # already at the common L
    assert st.window.slots == st.ell_idx.numel()

    def no_plan(*a, **k):
        raise AssertionError("a window was planned again")
    monkeypatch.setattr("repro_torch.core.sparse.window_plan", no_plan)
    for k in range(2):
        assert st[k].window is st.member_windows[k]
        assert st.astype(torch.float64)[k].window is st.member_windows[k]
    assert st.astype(torch.float64).window is st.window
    assert st.with_payload_dtype("bfloat16").member_windows \
        is st.member_windows


def test_batched_window_sums_the_members_costs():
    """One window for a batch: the band and halo whose staged rows and
    gathers summed over the members are fewest; a batch of one is the
    single plan."""
    rows = np.arange(256)[:, None]
    lattice = ((rows + np.array([-2, -1, 1, 2])) % 256).astype(np.int32)
    one = ell_mod.window_plan(lattice)
    assert ell_mod.window_plan(lattice[None]) == one
    both = ell_mod.window_plan(np.stack([lattice, lattice]))
    assert (both.band_rows, both.halo) == (one.band_rows, one.halo)
    assert both.in_window == 2 * one.in_window and both.slots == 2 * one.slots


def test_stacked_gossip_seams_match_the_dense_stack():
    """``gossip_mix`` and ``debiased_gossip`` over a stacked SparseW against
    the same stack of dense (B, N, N) weights (f32 sums in another order:
    1e-6 of the largest entry)."""
    graphs = [jtopo.watts_strogatz(24, k=4, p=0.2, seed=s) for s in (1, 2)]
    sparse = [SparseConsensus(Graph(g.adjacency), device="cpu")
              for g in graphs]
    dense = [DenseConsensus(Graph(g.adjacency), sparse=False, device="cpu")
             for g in graphs]
    st = SparseW.stack([e._w for e in sparse])
    wd = torch.stack([e._w for e in dense])
    z = torch.randn((2, 24, 3, 2), generator=torch.Generator().manual_seed(0))
    mixed = gossip_mix(wd, z)
    assert float((gossip_mix(st, z) - mixed).abs().max()) <= 1e-6 * float(
        mixed.abs().max())
    tables = torch.stack([e.debias_table(6) for e in sparse])
    got = debiased_gossip(st, tables, z, 5, 6)
    want = debiased_gossip(wd, torch.stack([e.debias_table(6)
                                            for e in dense]), z, 5, 6)
    # the debias divides by W^t e_1, which is small far from node 0: held
    # relative to the largest entry
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


# ---------------------------------------------------------------------------
# fused sparse B-DOT
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def grid_problem():
    rng = np.random.default_rng(9)
    dims_i, ns_j = [5, 4, 3], [12, 10, 14]
    grid = [[rng.standard_normal((di, nj)).astype(np.float32) for nj in ns_j]
            for di in dims_i]
    xb = np.concatenate([np.concatenate(row, 1) for row in grid], 0)
    q_true = np.linalg.eigh(xb @ xb.T / xb.shape[1])[1][:, ::-1][:, :3].copy()
    return dict(grid=grid, q_true=q_true, r=3,
                q_init=t32(j_init(jax.random.PRNGKey(0), 12, 3)))


def _bdot_engines(jcol, jrow, sparse, n=3):
    col = [_pair(jcol, sparse) for _ in range(n)]
    row = [_pair(jrow, sparse) for _ in range(n)]
    return ([c[0] for c in col], [r[0] for r in row],
            [c[1] for c in col], [r[1] for r in row])


def test_bdot_sparse_stacked_engines(grid_problem):
    """Fused B-DOT over all-sparse stages (each stage one stacked SparseW)
    against the reference's fused sparse B-DOT from the same init, the
    port's dense-engine run and the port's eager sparse run."""
    p = grid_problem
    gi, gj = jtopo.ring(3), jtopo.erdos_renyi(3, 0.9, seed=2)
    jcols, jrows, tcols, trows = _bdot_engines(gi, gj, sparse=True)
    kw = dict(r=3, t_outer=5, t_c=10)
    ref_run = j_bdot(blocks=[[jnp.asarray(b) for b in row]
                             for row in p["grid"]],
                     col_engines=jcols, row_engines=jrows,
                     q_true=jnp.asarray(p["q_true"]), **kw)
    tkw = dict(blocks=[[t32(b) for b in row] for row in p["grid"]],
               q_init=p["q_init"], q_true=t32(p["q_true"]), device="cpu",
               **kw)
    fused = bdot(col_engines=tcols, row_engines=trows, **tkw)
    eager = bdot(col_engines=tcols, row_engines=trows, fused=False, **tkw)
    _, _, dcols, drows = _bdot_engines(gi, gj, sparse=False)
    dense = bdot(col_engines=dcols, row_engines=drows, **tkw)
    assert _principal_angle_f64(fused.q_full, ref_run.q_full) <= TOL
    assert _principal_angle_f64(fused.q_full, dense.q_full) <= TOL
    np.testing.assert_allclose(fused.q_full.numpy(), eager.q_full.numpy(),
                               atol=TOL)
    np.testing.assert_allclose(fused.error_trace, ref_run.error_trace,
                               atol=TOL)
    assert fused.ledger.p2p == eager.ledger.p2p == ref_run.ledger.p2p


def test_bdot_mixed_stage_and_sparse_sweeps_are_refused(grid_problem, psa):
    p = grid_problem
    gi = jtopo.ring(3)
    _, _, scols, srows = _bdot_engines(gi, gi, sparse=True)
    _, _, dcols, _ = _bdot_engines(gi, gi, sparse=False)
    with pytest.raises(ValueError, match="mixes sparse and dense"):
        bdot(blocks=[[t32(b) for b in row] for row in p["grid"]],
             col_engines=scols[:2] + dcols[2:], row_engines=srows, r=3,
             t_outer=2, t_c=4, device="cpu")
    with pytest.raises(ValueError, match="sparse"):
        sdot_sweep(covs=t32(psa["covs"]),
                   engines=[_pair(psa["g"], sparse=True)[1]],
                   schedules=[np.full(4, 4)], r=psa["r"], t_outer=4, t_c=4,
                   seeds=[0], q_true=t32(psa["q_true"]))


# ---------------------------------------------------------------------------
# baselines over a SparseW engine, and a chunked resume on one
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["dsa", "dpgd", "deepca", "seq_dist_pm"])
def test_baselines_sparse_vs_dense_fused_and_eager(psa, name):
    """Each baseline mixing through the ELL round against the same run on
    the dense engine, fused and eager, at the reference's 1e-5; and the
    fused sparse run against the reference's sparse run from its init."""
    kw = (dict(iters_per_vec=4, t_c=8) if name == "seq_dist_pm"
          else dict(t_outer=8))
    j_sp, t_sp = _pair(psa["g"], sparse=True)
    _, t_dn = _pair(psa["g"], sparse=False)
    fn = getattr(tb, name)
    common = dict(q_true=t32(psa["q_true"]), q_init=psa["q_init"],
                  device="cpu", **kw)
    runs = {}
    for fused in (True, False):
        qd, ed = fn(t32(psa["covs"]), t_dn, psa["r"], fused=fused, **common)
        qs, es = fn(t32(psa["covs"]), t_sp, psa["r"], fused=fused, **common)
        np.testing.assert_allclose(qd.numpy(), qs.numpy(), atol=TOL)
        np.testing.assert_allclose(ed, es, atol=TOL)
        runs[fused] = (qs, es)
    q_ref, e_ref = getattr(jb, name)(jnp.asarray(psa["covs"]), j_sp,
                                     psa["r"], q_true=jnp.asarray(
                                         psa["q_true"]), **kw)
    np.testing.assert_allclose(runs[True][0].numpy(), np.asarray(q_ref),
                               atol=TOL)
    np.testing.assert_allclose(runs[True][1], np.asarray(e_ref), atol=TOL)


def test_sparse_run_chunked_resume_bit_identical(psa, tmp_path):
    """S-DOT on the sparse engine: killed after 2 chunks of 3 and resumed,
    bit for bit the monolithic run; its trace within 1e-5 of the
    reference's sparse run from the same init."""
    g = Graph(psa["g"].adjacency)

    def program():
        return sdot_program(covs=t32(psa["covs"]),
                            engine=SparseConsensus(g, device="cpu"),
                            r=psa["r"], t_outer=9, t_c=6,
                            q_init=psa["q_init"], q_true=t32(psa["q_true"]),
                            device="cpu")

    mono = run_monolithic(program())
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    run_chunked(program(), mgr, chunk_size=3, max_chunks=2)     # "killed"
    resumed = run_chunked(program(), mgr, chunk_size=3)         # restart
    assert torch.equal(mono.q_nodes, resumed.q_nodes)
    np.testing.assert_array_equal(mono.error_trace, resumed.error_trace)
    ref_run = j_run_monolithic(j_sdot_program(
        covs=jnp.asarray(psa["covs"]), engine=JSparse(psa["g"]), r=psa["r"],
        t_outer=9, t_c=6, q_true=jnp.asarray(psa["q_true"])))
    np.testing.assert_allclose(mono.error_trace, ref_run.error_trace,
                               atol=TOL)
