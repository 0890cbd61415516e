"""Training the MoE, recurrent and frontend families (CPU): the port's
``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
reference's, and PSA compression of the MoE expert stacks.

Families: kimi-k2-1t-a32b and phi3.5-moe (MoE dispatch and capacity drops
under autograd), xlstm-1.3b (mLSTM's chunk loop, sLSTM's loop over time),
recurrentgemma-2b (RG-LRU's doubling scan and f32 gates), paligemma-3b (the
patch splice: the token ids under the patches reach nothing) and
musicgen-medium (the (b, s, K, V) head).
Reduced configs in f32; the weights from the port's ``init_params`` (seed
0) and the batch from its ``make_lm_batch``, handed to the reference as
numpy arrays. The
reference runs with its layers unrolled, no remat, and XLA's backend
optimisation level 0: the same math, compiled in a fraction of the time.

Tolerances: LOSS_TOL 1e-5 relative; GRAD_TOL 5e-5 of each leaf's largest
|gradient| (both sides f32, the same operations summed in another order;
RG-LRU's scan takes another tree of the same combine: its ``lam`` reads
9.3e-6, the largest; every other leaf <= 1.3e-6). The PSA compressor on the expert stacks, whose
projector is shared by a group's experts (z summed over them): PSA_TOL, as
tests/test_torch_train.py.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.configs.base import PSAConfig as JPSAConfig
from repro.optim.psa_compress import compress_grads as jcompress
from repro.optim.psa_compress import psa_init as jpsa_init
from repro.optim.psa_compress import psa_refresh as jrefresh
from repro.train.step import loss_fn as jloss_fn
from repro_torch import _tree
from repro_torch import configs as tcfg
from repro_torch.configs.base import PSAConfig
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.models import transformer as tt
from repro_torch.optim.psa_compress import compress_grads, psa_init, \
    psa_refresh
from repro_torch.train.step import _value_and_grad, loss_fn

FAMILIES = ("kimi-k2-1t-a32b", "phi3.5-moe-42b-a6.6b", "xlstm-1.3b",
            "recurrentgemma-2b", "paligemma-3b", "musicgen-medium")
B, S = 2, 32
LOSS_TOL = 1e-5
GRAD_TOL = 5e-5
PSA_TOL = 1e-5
PSA_CFG = dict(rank=4, oi_iters=2, gossip_rounds=2)


@pytest.fixture(scope="module")
def family():
    """aid -> the reference's loss and gradients on a reduced config, and
    the port's parameters and batch."""
    cache = {}

    def get(aid):
        if aid not in cache:
            jc = jcfg.reduced_config(jcfg.get_arch(aid))
            tc = tcfg.reduced_config(tcfg.get_arch(aid))
            tparams = tt.init_params(torch.Generator().manual_seed(0), tc,
                                     device="cpu")
            batch = make_lm_batch(tc, 0, 0, B, S, device="cpu")
            params = tt.tree_map(lambda t: t.numpy(), tparams)
            jbatch = {k: v.numpy() for k, v in batch.items()}
            vg = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(
                p, b, jc, remat=False, unroll_layers=True))).lower(
                params, jbatch).compile(
                    {"xla_backend_optimization_level": 0})
            loss, grads = vg(params, jbatch)
            cache[aid] = dict(
                jc=jc, tc=tc, loss=float(loss),
                grads=jax.tree.map(np.asarray, grads), tparams=tparams,
                batch=batch)
        return cache[aid]
    return get


@pytest.mark.parametrize("aid", FAMILIES)
def test_loss_and_gradients_match_reference(aid, family):
    f = family(aid)
    loss, grads = _value_and_grad(f["tparams"], f["batch"], f["tc"])
    np.testing.assert_allclose(float(loss), f["loss"], rtol=LOSS_TOL)
    np.testing.assert_allclose(float(loss_fn(f["tparams"], f["batch"],
                                             f["tc"])), f["loss"],
                               rtol=LOSS_TOL)
    names, got, _ = _tree.flatten_with_names(grads)
    want_names, want, _ = _tree.flatten_with_names(f["grads"])
    assert names == want_names
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_vlm_tokens_under_the_patches_reach_nothing(family):
    """paligemma splices ``patch_embeds`` over the first n_prefix_tokens
    positions: the token ids there are read by nothing, so other ids give
    the same loss and gradients bit for bit."""
    f = family("paligemma-3b")
    npfx = f["tc"].n_prefix_tokens
    other = dict(f["batch"])
    other["tokens"] = f["batch"]["tokens"].clone()
    other["tokens"][:, :npfx] = (other["tokens"][:, :npfx] + 1) \
        % f["tc"].vocab_size
    loss, grads = _value_and_grad(f["tparams"], f["batch"], f["tc"])
    loss2, grads2 = _value_and_grad(f["tparams"], other, f["tc"])
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(
        _tree.tree_leaves(grads), _tree.tree_leaves(grads2)))


@pytest.mark.parametrize("aid", ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"])
def test_psa_compression_of_expert_stacks_matches_reference(aid, family):
    """The (G, E, D, F) expert stacks take one (G, D, r) projector a group,
    z summed over the experts: compress (reduced gradients and error
    feedback, every leaf) and refresh (the expert stacks) with no pod axis,
    on the reference's gradients and projectors. The refresh is compared
    on the stacks alone: the router's gradient has rank r - 1 at most (its
    rows sum to zero over the experts, a softmax's), where a projector's
    last column is the QR's choice (the port's bounded shifted CholeskyQR3
    against the reference's one pass)."""
    f = family(aid)
    psa = PSAConfig(**PSA_CFG)
    jstate = jpsa_init(jax.tree.map(np.asarray, f["grads"]),
                       JPSAConfig(**PSA_CFG), seed=0)
    proj = jax.tree.map(np.asarray, jstate["proj"])
    red, ef = jax.jit(lambda g, s: jcompress(g, s, JPSAConfig(**PSA_CFG),
                                             pod_axis=None))(
        f["grads"], jstate)
    fresh = jax.jit(lambda g, s: jrefresh(g, s, JPSAConfig(**PSA_CFG),
                                          pod_axis=None))(f["grads"], jstate)
    tgrads = {k: v for k, v in _tree_tensors(f["grads"]).items()}
    state = psa_init(tgrads, psa, proj=proj)
    stack = state["proj"]["groups"]["blk0_attn"]["ffn"]["w_gate"]
    assert tuple(stack.shape) == (1, f["tc"].d_model, psa.rank)
    tred, tef = compress_grads(tgrads, state, psa)
    tfresh = psa_refresh(tgrads, state, psa)
    stacks = ("ffn/w_gate", "ffn/w_up", "ffn/w_down")
    for got, want, every in ((tred, red, True), (tef, ef, True),
                             (tfresh["proj"], fresh["proj"], False)):
        names, g_leaves, _ = _tree.flatten_with_names(got)
        w_named = dict(zip(*_tree.flatten_with_names(
            jax.tree.map(np.asarray, want))[:2]))
        assert any("ffn/w_down" in n for n in names)
        for name, g in zip(names, g_leaves):
            if not every and not name.endswith(stacks):
                continue
            w = w_named[name]
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g.numpy() - w).max()) <= PSA_TOL * scale, \
                name


def _tree_tensors(tree):
    if isinstance(tree, dict):
        return {k: _tree_tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))
