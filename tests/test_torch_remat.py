"""Remat (activation checkpointing) in every train step (CPU): the twin of
the reference's ``forward(..., remat=True | "names" | False)``.

For each of the ten families (reduced configs, f32; the weights from the
port's ``init_params``, seed 0, the batch from ``make_lm_batch``): the
loss and every gradient under ``remat=True`` and ``"names"`` equal those
under ``False`` bit for bit (the recomputation runs the same operations on
the same inputs); the bytes saved for backward, counted with
``torch.autograd.graph.saved_tensors_hooks``, order ``True`` < ``"names"``
< ``False``; a recomputed MoE layer routes its tokens exactly as its first
pass did. For qwen2-7b, phi3.5-moe and recurrentgemma-2b the gradients at
``True`` and ``"names"`` match ``jax.value_and_grad`` of the reference's
``loss_fn`` at the same remat, its layers unrolled and compiled at XLA's
backend optimisation level 0, within GRAD_TOL of each leaf's largest
|gradient| (tests/test_torch_train_families.py's limit). The analytic cost
follows the step's remat.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch.analytic_cost import analytic_cost as janalytic_cost
from repro.train.step import loss_fn as jloss_fn
from repro_torch import _tree
from repro_torch import configs as tcfg
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.launch import roofline
from repro_torch.launch.analytic_cost import analytic_cost
from repro_torch.models import moe
from repro_torch.models import transformer as tt
from repro_torch.train.step import _value_and_grad, make_train_step

B, S = 2, 32
LOSS_TOL = 1e-5
GRAD_TOL = 5e-5
AGAINST_REFERENCE = ("qwen2-7b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-2b")
MOE = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b")


def _setup(aid):
    cfg = tcfg.reduced_config(tcfg.get_arch(aid))
    params = tt.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    return cfg, params, make_lm_batch(cfg, 0, 0, B, S, device="cpu")


@pytest.fixture(scope="module")
def runs():
    """aid -> remat -> (loss, gradient leaves, bytes saved for backward)."""
    cache = {}

    def get(aid):
        if aid not in cache:
            cfg, params, batch = _setup(aid)
            out = {}
            for remat in tt.REMAT_MODES:
                saved = [0]

                def pack(t):
                    saved[0] += t.numel() * t.element_size()
                    return t

                with torch.autograd.graph.saved_tensors_hooks(pack,
                                                              lambda t: t):
                    loss, grads = _value_and_grad(params, batch, cfg,
                                                  remat=remat)
                out[remat] = (loss, grads, saved[0])
            cache[aid] = out
        return cache[aid]
    return get


@pytest.mark.parametrize("aid", tcfg.ARCH_IDS)
def test_remat_gives_the_same_bits(runs, aid):
    res = runs(aid)
    loss, grads, _ = res[False]
    for remat in (True, "names"):
        got_loss, got, _ = res[remat]
        assert torch.equal(got_loss, loss), remat
        for name, a, b in zip(_tree.flatten_with_names(grads)[0],
                              _tree.tree_leaves(got),
                              _tree.tree_leaves(grads)):
            assert torch.equal(a, b), (remat, name)


@pytest.mark.parametrize("aid", tcfg.ARCH_IDS)
def test_remat_saves_fewer_bytes(runs, aid):
    """True keeps a group's input, "names" a block's input and its residual
    after the mixer, False everything autograd saves."""
    res = runs(aid)
    assert res[True][2] < res["names"][2] < res[False][2]


@pytest.mark.parametrize("aid", MOE)
@pytest.mark.parametrize("remat", [True, "names"])
def test_recomputed_moe_routes_as_the_first_pass(aid, remat):
    """Each MoE layer is routed twice under remat (the forward and its
    recomputation, the stable sort by expert making it deterministic):
    the gates, kept pairs and slots equal bit for bit."""
    cfg, params, batch = _setup(aid)
    inner, plans = moe.route, []

    def recording(xf, router, m, cap):
        plan = inner(xf, router, m, cap)
        plans.append([t.clone() for t in plan])
        return plan

    moe.route = recording
    try:
        _value_and_grad(params, batch, cfg, remat=remat)
    finally:
        moe.route = inner
    n = cfg.n_layers
    assert len(plans) == 2 * n
    for first, again in zip(plans[:n], plans[n:]):
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("aid", AGAINST_REFERENCE)
@pytest.mark.parametrize("remat", [True, "names"])
def test_remat_gradients_match_the_reference(runs, aid, remat):
    jc = jcfg.reduced_config(jcfg.get_arch(aid))
    cfg, params, batch = _setup(aid)
    jparams = tt.tree_map(lambda t: t.numpy(), params)
    jbatch = {k: v.numpy() for k, v in batch.items()}
    vg = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(
        p, b, jc, remat=remat, unroll_layers=True))).lower(
        jparams, jbatch).compile({"xla_backend_optimization_level": 0})
    want_loss, want = vg(jparams, jbatch)
    loss, grads, _ = runs(aid)[remat]
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_TOL)
    names, got, _ = _tree.flatten_with_names(grads)
    want_names, want, _ = _tree.flatten_with_names(
        jax.tree.map(np.asarray, want))
    assert names == want_names
    for name, g, w in zip(names, got, want):
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * max(float(np.abs(w).max()), 1e-30), name


def test_train_step_takes_remat():
    """``make_train_step``'s default is the reference's (``True``); every
    remat gives the same step; an unknown mode is refused."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    cfg, params, batch = _setup("qwen2-7b")
    opt = AdamWConfig(warmup_steps=1)
    out = {}
    for remat in (None, False, True, "names"):
        kw = {} if remat is None else {"remat": remat}
        step = make_train_step(cfg, opt, donate=False, **kw)
        p, _, met = step(params, adamw_init(params, opt), batch)
        out[remat] = (float(met["loss"]), _tree.tree_leaves(p))
    for remat in (False, True, "names"):
        assert out[remat][0] == out[None][0]
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1],
                                                     out[None][1]))
    with pytest.raises(ValueError, match="remat"):
        _value_and_grad(params, batch, cfg, remat="full")


@pytest.mark.parametrize("shape_id", ["train_4k", "prefill_32k"])
def test_analytic_cost_follows_remat(shape_id):
    """The default is the reference's model (a recomputed forward), which
    "names" keeps (it recomputes its spans' GEMMs); False counts 3x the
    forward and two weight reads."""
    cfg = tcfg.get_arch("qwen2-7b")
    shape = tcfg.SHAPES[shape_id]
    ref = janalytic_cost(jcfg.get_arch("qwen2-7b"), jcfg.SHAPES[shape_id])
    full = analytic_cost(cfg, shape)
    assert full == analytic_cost(cfg, shape, remat=True) == analytic_cost(
        cfg, shape, remat="names")
    np.testing.assert_allclose(full["flops"], ref["flops"], rtol=1e-12)
    np.testing.assert_allclose(full["hbm_bytes"], ref["hbm_bytes"],
                               rtol=1e-12)
    got = analytic_cost(cfg, shape, remat=False)
    if shape.kind != "train":
        assert got == full
        return
    np.testing.assert_allclose(got["flops"] / full["flops"], 3 / 4,
                               rtol=1e-12)
    n = cfg.param_count() * cfg.torch_dtype.itemsize
    assert full["weight_bytes"] - got["weight_bytes"] == n
    res = roofline.run_cell("qwen2-7b", shape, remat=False)
    assert res["flops_per_dev"] == roofline.run_cell(
        "qwen2-7b", shape)["flops_per_dev"] * 3 / 4
