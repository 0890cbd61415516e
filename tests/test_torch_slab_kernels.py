"""The slab and grid products of F-DOT and B-DOT: the port's plain versions
against ``repro.kernels.ref`` and the interpret-mode Pallas kernels, the
exactness of zero padding, and the CPU dispatch of ``repro_torch.kernels.ops``
(CPU). The Hopper kernels against these plain versions are in
``test_torch_gpu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as jc
from repro.core import topology as jtopo
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import consensus as tc
from repro_torch.kernels import ops, ref

# f32 sums in another order than the reference (XLA CPU / Pallas interpret)
RTOL, ATOL = 1e-4, 1e-4

# name -> (shape of X, shape of the second operand), from the grid (I, J),
# d, n and r; the slab functions take the grid's first column or row
KERNELS = {
    "batched_slab_tq": (lambda g, d, n: (g[0], d, n),
                        lambda g, d, n, r: (g[0], d, r)),
    "batched_slab_apply": (lambda g, d, n: (g[0], d, n),
                           lambda g, d, n, r: (g[0], n, r)),
    "grid_block_tq": (lambda g, d, n: (*g, d, n),
                      lambda g, d, n, r: (g[0], d, r)),
    "grid_block_apply": (lambda g, d, n: (*g, d, n),
                         lambda g, d, n, r: (g[1], n, r)),
}
SHAPES = {"aligned": ((4, 2), 8, 512, 4), "ragged": ((3, 2), 7, 700, 5),
          "one-column": ((2, 1), 5, 1, 3),
          # a grid of many small blocks, as bdot_sparse's (n = 14 samples a
          # block): the shapes the kernels' packed route takes on the card
          "tiny-blocks": ((2, 16), 20, 14, 5)}


def _operands(name, shape, seed):
    grid, d, n, r = SHAPES[shape]
    x_shape, y_shape = KERNELS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape(grid, d, n)).astype(np.float32)
    y = rng.standard_normal(y_shape(grid, d, n, r)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(KERNELS))
def test_plain_version_matches_reference_and_pallas(name, shape):
    x, y = _operands(name, shape, seed=len(name) + len(shape))
    before = dict(ops.LAUNCHES)
    got = getattr(ops, name)(torch.from_numpy(x), torch.from_numpy(y))
    assert ops.LAUNCHES == before            # the CPU path launches nothing
    plain = getattr(ref, f"{name}_ref")(torch.from_numpy(x),
                                        torch.from_numpy(y))
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    want_ref = np.asarray(getattr(jref, f"{name}_ref")(jnp.asarray(x),
                                                       jnp.asarray(y)))
    want_pallas = np.asarray(getattr(jops, name)(
        jnp.asarray(x), jnp.asarray(y), block_n=256, use_pallas=True,
        interpret=True))
    assert got.shape == want_ref.shape
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=RTOL,
                               atol=ATOL)


def test_slab_ops_zero_row_padding_exact():
    """Padded feature rows of a ragged slab stack stay null (F-DOT)."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 6, 512)).astype(np.float32)
    q = rng.standard_normal((2, 6, 3)).astype(np.float32)
    s = rng.standard_normal((2, 512, 3)).astype(np.float32)
    x[1, 4:] = 0.0                  # node 1 has only 4 real features
    q[1, 4:] = 0.0
    xt, qt, st = map(torch.from_numpy, (x, q, s))
    z = ops.batched_slab_tq(xt, qt)
    v = ops.batched_slab_apply(xt, st)
    want_z = ref.batched_slab_tq_ref(xt[1:, :4], qt[1:, :4])
    torch.testing.assert_close(z[1], want_z[0], rtol=RTOL, atol=ATOL)
    assert torch.count_nonzero(v[1, 4:]) == 0
    want_j = np.asarray(jops.batched_slab_tq(
        jnp.asarray(x), jnp.asarray(q), block_n=256, use_pallas=True,
        interpret=True))
    np.testing.assert_allclose(z.numpy(), want_j, rtol=RTOL, atol=ATOL)


def test_grid_ops_zero_padding_exact():
    """Padded feature rows AND sample columns of the (I, J) stack stay null
    (the fused B-DOT masking invariants)."""
    rng = np.random.default_rng(33)
    x = rng.standard_normal((2, 2, 6, 512)).astype(np.float32)
    q = rng.standard_normal((2, 6, 3)).astype(np.float32)
    s = rng.standard_normal((2, 512, 3)).astype(np.float32)
    x[1, :, 4:] = 0.0               # grid row 1 has 4 real features
    q[1, 4:] = 0.0
    x[:, 1, :, 400:] = 0.0          # grid column 1 has 400 real samples
    s[1, 400:] = 0.0
    xt, qt, st = map(torch.from_numpy, (x, q, s))
    z = ops.grid_block_tq(xt, qt)
    v = ops.grid_block_apply(xt, st)
    assert torch.count_nonzero(z[:, 1, 400:]) == 0
    assert torch.count_nonzero(v[1, :, 4:]) == 0
    want = ref.grid_block_tq_ref(xt[1:, 1:, :4, :400], qt[1:, :4])
    torch.testing.assert_close(z[1, 1, :400], want[0, 0], rtol=RTOL,
                               atol=ATOL)
    want_j = np.asarray(jops.grid_block_apply(
        jnp.asarray(x), jnp.asarray(s), block_n=256, use_pallas=True,
        interpret=True))
    np.testing.assert_allclose(v.numpy(), want_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stage", ["columns", "rows"])
def test_batched_debiased_gossip_matches_per_network_and_reference(stage):
    """B-DOT's stacked gossip (one batched matmul per round) equals the
    per-sub-network gossip and the reference's vmap over engines."""
    n_nets, n = (3, 4) if stage == "columns" else (4, 3)
    ws = [jc.DenseConsensus(jtopo.erdos_renyi(n, 0.7, seed=k)) for k in
          range(n_nets)]
    t_max, t_c = 9, 6
    z = np.random.default_rng(7).standard_normal((n_nets, n, 11, 3)).astype(
        np.float32)
    w_stack = torch.tensor(np.stack([np.asarray(e._w) for e in ws]))
    tables = torch.stack([tc.debias_table(w, t_max) for w in w_stack])
    got = tc.debiased_gossip(w_stack, tables, torch.from_numpy(z), t_c, t_max)
    for k in range(n_nets):
        one = tc.debiased_gossip(w_stack[k], tables[k], torch.from_numpy(z[k]),
                                 t_c, t_max)
        torch.testing.assert_close(got[k], one, rtol=1e-6, atol=1e-6)
    want = jax.vmap(jc.debiased_gossip, in_axes=(0, 0, 0, None, None))(
        jnp.stack([e._w for e in ws]),
        jnp.stack([jc.debias_table(e._w, t_max) for e in ws]),
        jnp.asarray(z), t_c, t_max)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
