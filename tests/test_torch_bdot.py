"""B-DOT (block-partitioned DOT): the port against the reference on the same
NumPy inputs (twins of ``tests/test_bdot.py`` and of the B-DOT half of
``tests/test_bdot_fused.py``), and the port's fused loop against its eager
oracle (CPU)."""
import jax
import numpy as np
import pytest
import torch

from repro.core import bdot as jbdot
from repro.core import topology as jtopo
from repro.core.consensus import DenseConsensus as JDense, consensus_schedule
from repro.core.linalg import eigh_topr, orthonormal_init as j_init
from repro.data.pipeline import (gaussian_eigengap_data, partition_features,
                                 partition_samples)
from repro_torch.core import bdot as tbdot
from repro_torch.core.consensus import DenseConsensus, SparseConsensus
from repro_torch.core.metrics import subspace_error
from repro_torch.core.oi import orthogonal_iteration
from repro_torch.core.topology import Graph
from repro_torch.interop import from_reference_arrays

TRACE_ATOL = 1e-5     # f32 on both sides; gossip and QR sum in another order
Q_ATOL = 1e-5         # q_full element by element (the same iterate)
LEDGER_FIELDS = ("p2p", "matrices", "scalars", "payload_bytes")


def _split_cols(x, sizes):
    offs = np.cumsum([0] + list(sizes))
    return [x[:, offs[k]:offs[k + 1]] for k in range(len(sizes))]


def _grid_problem(d=24, r=4, I=4, J=5, n=3000, gap=0.6, ragged=False,
                  seed=0):
    x, _, _ = gaussian_eigengap_data(d, n, r, gap, seed=seed)
    _, q_true = eigh_topr(x @ x.T, r)
    fslabs = partition_features(x, I)           # ragged d_i when I !| d
    if ragged:
        sizes = [n // J + 100 * (1 if k == 0 else -1) for k in range(J)]
        sizes[-1] = n - sum(sizes[:-1])
        blocks = [_split_cols(sl, sizes) for sl in fslabs]
    else:
        blocks = [partition_samples(sl, J) for sl in fslabs]
    return x, blocks, q_true


def _graphs(I, J, kind="er", seed=0):
    """Column graphs over I nodes and row graphs over J nodes, as
    ``tests/test_bdot_fused.py`` builds them (ER, or a ring for 2 nodes)."""
    def one(n, s):
        if kind == "complete":
            return jtopo.complete(n)
        return jtopo.erdos_renyi(n, 0.7, seed=s) if n > 2 else jtopo.ring(n)
    return ([one(I, seed + j) for j in range(J)],
            [one(J, seed + 10 + i) for i in range(I)])


def _run_both(blocks, cols, rows, r, q_init, q_true=None, **kw):
    """The reference's fused B-DOT and the port's fused and eager runs on
    the same inputs; asserts port fused == port eager (the reference's own
    fused-vs-eager tolerances) and returns (reference, port fused)."""
    ref = jbdot.bdot(blocks=blocks, col_engines=[JDense(g) for g in cols],
                     row_engines=[JDense(g) for g in rows], r=r,
                     q_init=q_init, q_true=q_true, **kw)
    arrays = {"grid": [[np.asarray(b) for b in row] for row in blocks],
              "col_adjacency": [g.adjacency for g in cols],
              "row_adjacency": [g.adjacency for g in rows],
              "q_init": np.asarray(q_init)}
    if q_true is not None:
        arrays["q_true"] = np.asarray(q_true)
    st = from_reference_arrays(arrays, device="cpu")
    port_kw = dict(blocks=st["blocks"], col_engines=st["col_engines"],
                   row_engines=st["row_engines"], r=r, q_init=st["q_init"],
                   q_true=st.get("q_true"), device="cpu", **kw)
    fused = tbdot.bdot(fused=True, **port_kw)
    eager = tbdot.bdot(fused=False, **port_kw)
    if q_true is not None:
        np.testing.assert_allclose(fused.error_trace, eager.error_trace,
                                   rtol=1e-4, atol=1e-5)
    for fb, eb in zip(fused.q_rows, eager.q_rows):
        assert fb.shape == eb.shape
        torch.testing.assert_close(fb, eb, rtol=1e-4, atol=1e-5)
    for field in LEDGER_FIELDS:
        assert getattr(fused.ledger, field) == getattr(eager.ledger, field)
    return ref, fused


def _assert_parity(port, ref):
    if ref.error_trace is not None:
        np.testing.assert_allclose(port.error_trace,
                                   np.asarray(ref.error_trace), rtol=0,
                                   atol=TRACE_ATOL)
    assert [q.shape for q in port.q_rows] == [tuple(q.shape)
                                              for q in ref.q_rows]
    np.testing.assert_allclose(port.q_full.numpy(), np.asarray(ref.q_full),
                               rtol=0, atol=Q_ATOL)
    for field in LEDGER_FIELDS:
        assert getattr(port.ledger, field) == getattr(ref.ledger, field)


# ---------------------------------------------------------------------------
# twins of tests/test_bdot.py (4 x 5 grid)
# ---------------------------------------------------------------------------
def test_bdot_converges():
    _, blocks, q_true = _grid_problem()
    cols, rows = _graphs(4, 5)
    ref, port = _run_both(blocks, cols, rows, 4,
                          j_init(jax.random.PRNGKey(0), 24, 4), q_true,
                          t_outer=60, t_c=60)
    assert port.error_trace[-1] < 1e-5
    q = port.q_full
    torch.testing.assert_close(q.T @ q, torch.eye(4), rtol=0, atol=1e-4)
    _assert_parity(port, ref)


def test_bdot_blocks_cover_data():
    x, blocks, _ = _grid_problem()
    st = from_reference_arrays(
        {"grid": [[np.asarray(b) for b in row] for row in blocks]},
        device="cpu")
    rebuilt = torch.cat([torch.cat(row, dim=1) for row in st["blocks"]])
    np.testing.assert_array_equal(rebuilt.numpy(), np.asarray(x))


def test_bdot_payloads_are_blockwise():
    """Per-node traffic never includes a full d x r or d x n object."""
    _, blocks, q_true = _grid_problem()
    I, J = len(blocks), len(blocks[0])
    cols, rows = _graphs(I, J, kind="complete")
    ref, port = _run_both(blocks, cols, rows, 4,
                          j_init(jax.random.PRNGKey(0), 24, 4), q_true,
                          t_outer=3, t_c=10)
    d, n, r = 24, 3000, 4
    n_j, d_i = n // J, d // I
    per_iter_elems = (
        10 * (I * (I - 1)) * n_j * r * J          # stage 1 per column
        + 10 * (J * (J - 1)) * d_i * r * I        # stage 2 per row
        + 2 * 10 * (I * (I - 1)) * r * r          # QR grams (2 passes)
    )
    assert port.ledger.scalars == pytest.approx(3 * per_iter_elems)
    _assert_parity(port, ref)


def test_bdot_matches_centralized_oi_exact_consensus():
    x, blocks, _ = _grid_problem()
    cols, rows = _graphs(4, 5, kind="complete")
    q0 = j_init(jax.random.PRNGKey(1), 24, 4)
    ref, port = _run_both(blocks, cols, rows, 4, q0, t_outer=8, t_c=150)
    xt = torch.tensor(np.asarray(x))
    q_oi = orthogonal_iteration(xt @ xt.T, torch.tensor(np.asarray(q0)), 8)
    assert float(subspace_error(q_oi, port.q_full)) < 1e-5
    _assert_parity(port, ref)


# ---------------------------------------------------------------------------
# twins of the B-DOT half of tests/test_bdot_fused.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid", [(2, 2), (3, 2)])
@pytest.mark.parametrize("sched_kind", ["const", "lin2"])
def test_bdot_fused_matches_eager_and_reference(grid, sched_kind):
    I, J = grid
    _, blocks, q_true = _grid_problem(I=I, J=J)
    cols, rows = _graphs(I, J)
    sched = (None if sched_kind == "const"
             else consensus_schedule("lin2", 12, cap=40))
    ref, port = _run_both(blocks, cols, rows, 4,
                          j_init(jax.random.PRNGKey(2), 24, 4), q_true,
                          t_outer=12, t_c=40, schedule=sched)
    _assert_parity(port, ref)


def test_bdot_fused_ragged_grid():
    """Uneven d_i AND n_j: the (I, J, d_max, n_max) zero-padding must not
    change the result (d=25 over I=3 slabs, n split 1600/1400)."""
    _, blocks, q_true = _grid_problem(d=25, I=3, J=2, ragged=True)
    assert len({b.shape[0] for row in blocks for b in row}) > 1
    assert len({b.shape[1] for row in blocks for b in row}) > 1
    cols, rows = _graphs(3, 2, seed=5)
    ref, port = _run_both(blocks, cols, rows, 4,
                          j_init(jax.random.PRNGKey(3), 25, 4), q_true,
                          t_outer=10, t_c=40)
    _assert_parity(port, ref)


def test_bdot_fused_converges():
    _, blocks, q_true = _grid_problem(I=3, J=2)
    cols, rows = _graphs(3, 2)
    ref, port = _run_both(blocks, cols, rows, 4,
                          j_init(jax.random.PRNGKey(4), 24, 4), q_true,
                          t_outer=50, t_c=60)
    assert port.error_trace[-1] < 1e-5
    q = port.q_full
    torch.testing.assert_close(q.T @ q, torch.eye(4), rtol=0, atol=1e-4)
    _assert_parity(port, ref)


def test_bdot_short_schedule_rejected():
    _, blocks, _ = _grid_problem(I=3, J=2)
    cols, rows = _graphs(3, 2)
    st = from_reference_arrays(
        {"grid": [[np.asarray(b) for b in row] for row in blocks],
         "col_adjacency": [g.adjacency for g in cols],
         "row_adjacency": [g.adjacency for g in rows]}, device="cpu")
    for fused in (True, False):
        with pytest.raises(ValueError, match="schedule"):
            tbdot.bdot(blocks=st["blocks"], col_engines=st["col_engines"],
                       row_engines=st["row_engines"], r=4, t_outer=10,
                       schedule=np.array([5, 5]), fused=fused, device="cpu")


def test_pad_grid_blocks_layout():
    _, blocks, _ = _grid_problem(d=25, I=3, J=2, ragged=True)
    t_blocks = [[torch.tensor(np.asarray(b)) for b in row] for row in blocks]
    stack = tbdot.pad_grid_blocks(t_blocks)
    I, J = len(blocks), len(blocks[0])
    d_max = max(row[0].shape[0] for row in blocks)
    n_max = max(b.shape[1] for b in blocks[0])
    assert stack.shape == (I, J, d_max, n_max)
    np.testing.assert_array_equal(stack.numpy(),
                                  np.asarray(jbdot.pad_grid_blocks(blocks)))


def test_fused_bdot_rejects_sparse_stages():
    """A stage that mixes sparse and dense engines has no batched form and
    is refused; a stage of sparse engines runs fused as one stacked SparseW
    (one ELL round a launch for the whole stage), equal to the eager oracle
    within Q_ATOL / TRACE_ATOL, its ledger exactly."""
    _, blocks, q_true = _grid_problem(I=3, J=2)
    cols, rows = _graphs(3, 2)
    st = from_reference_arrays(
        {"grid": [[np.asarray(b) for b in row] for row in blocks],
         "q_true": np.asarray(q_true)}, device="cpu")
    sparse_cols = [SparseConsensus(Graph(g.adjacency), device="cpu")
                   for g in cols]
    dense_rows = [DenseConsensus(Graph(g.adjacency), device="cpu")
                  for g in rows]
    kw = dict(blocks=st["blocks"], r=4, t_outer=3, t_c=20, device="cpu")
    mixed = [sparse_cols[0]] + [
        DenseConsensus(Graph(g.adjacency), device="cpu") for g in cols[1:]]
    with pytest.raises(ValueError, match="mixes sparse and dense"):
        tbdot.bdot(col_engines=mixed, row_engines=dense_rows, **kw)
    fused = tbdot.bdot(col_engines=sparse_cols, row_engines=dense_rows,
                       q_true=st["q_true"], **kw)
    eager = tbdot.bdot(col_engines=sparse_cols, row_engines=dense_rows,
                       fused=False, q_true=st["q_true"], **kw)
    np.testing.assert_allclose(fused.error_trace, eager.error_trace,
                               atol=TRACE_ATOL)
    np.testing.assert_allclose(fused.q_full.numpy(), eager.q_full.numpy(),
                               atol=Q_ATOL)
    for f in LEDGER_FIELDS:
        assert getattr(fused.ledger, f) == getattr(eager.ledger, f), f