"""A tied head (``tie_embeddings``: no ``lm_head``, the logits are
x @ embed^T), unsplit, against the reference (CPU).

Reduced qwen2-7b and recurrentgemma-2b (one RG-LRU and one windowed layer)
with ``tie_embeddings=True``, 2 layers, f32. The weights come from the
reference's ``init_params`` and cross over with
``interop.params_from_reference``, which maps a tree with no ``lm_head``;
tokens are drawn with numpy from a seed. Held: ``forward``'s and
``decode_step``'s logits, the loss and every gradient against
``jax.value_and_grad`` of the reference's loss (the ``embed`` leaf takes
the lookup's gradient and the head's), and the PSA train step's ``embed``
gradient over two pod ranks (gloo, spawned), whose pod mean is the
gradient of the global batch's loss. The audio frontend with a tied head
is refused with a ``ValueError``, where the reference fails.

The ranks start by ``spawn`` and import this module: it imports no JAX at
module level.

Tolerances: F32_TOL 2e-5 absolute and relative on the logits and the loss
(f32 on both sides, sums in another order); GRAD_TOL 5e-5 of each leaf's
largest |gradient|, as tests/test_torch_train_families.py (RG-LRU's scan
takes another tree of the same combine).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch import configs as tcfg
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tt

F32_TOL = 2e-5
GRAD_TOL = 5e-5
B, S = 2, 32
DECODE_STEPS = 12              # past recurrentgemma's ring of WINDOW slots
WINDOW = 8
TIED = {"qwen2-7b": {"n_layers": 2},
        "recurrentgemma-2b": {"n_layers": 2, "window": WINDOW,
                              "block_pattern": ("rglru", "swa")}}
PSA_CFG = dict(rank=4, oi_iters=2, gossip_rounds=2)


def _cfg(configs, aid):
    return dataclasses.replace(
        configs.reduced_config(configs.get_arch(aid), **TIED[aid]),
        tie_embeddings=True)


@pytest.fixture(scope="module")
def tied():
    """aid -> the reference's params, logits, decode logits, loss and
    gradients, and the port's params (through interop) and batch."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jcfg
    from repro.models import transformer as jt
    from repro.train.step import loss_fn as jloss_fn
    from repro_torch.interop import params_from_reference
    out = {}
    for seed, aid in enumerate(TIED):
        jc, tc = _cfg(jcfg, aid), _cfg(tcfg, aid)
        jparams = jt.init_params(jax.random.PRNGKey(seed), jc)
        np_params = jax.tree.map(np.asarray, jparams)
        toks = np.random.default_rng(seed).integers(
            0, jc.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        logits = jax.jit(lambda p, x: jt.forward(p, {"tokens": x}, jc,
                                                 remat=False))(
            jparams, jnp.asarray(batch["tokens"]))
        step = jax.jit(lambda p, st, x: jt.decode_step(p, st, x, jc))
        state = jt.init_decode_state(jc, B, DECODE_STEPS)
        decoded = []
        for t in range(DECODE_STEPS):
            lg, state = step(jparams, state,
                             jnp.asarray(batch["tokens"][:, t:t + 1]))
            decoded.append(np.asarray(lg))
        vg = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(
            p, b, jc, remat=False, unroll_layers=True))).lower(
            np_params, batch).compile({"xla_backend_optimization_level": 0})
        loss, grads = vg(np_params, batch)
        out[aid] = {"cfg": tc, "np_params": np_params,
                    "params": params_from_reference(np_params, "cpu"),
                    "batch": {k: torch.from_numpy(v).long()
                              for k, v in batch.items()},
                    "logits": np.asarray(logits), "decode": decoded,
                    "loss": float(loss),
                    "grads": jax.tree.map(np.asarray, grads)}
    return out


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _grad_errs(got, want):
    """Per leaf: max |got - want| / max |want| (want: numpy arrays)."""
    names, w, _ = _tree.flatten_with_names(want)
    return {n: float(np.abs(g.detach().numpy() - x).max())
            / max(float(np.abs(x).max()), 1e-30)
            for n, g, x in zip(names, _tree.tree_leaves(got), w)}


@pytest.mark.parametrize("aid", TIED)
def test_interop_maps_a_tied_tree(tied, aid):
    """The reference's tied tree has no ``lm_head``; interop carries it
    leaf for leaf, and the port's own ``init_params`` makes the same
    tree."""
    o = tied[aid]
    assert "lm_head" not in o["np_params"] and "lm_head" not in o["params"]
    mine = tt.init_params(None, o["cfg"], device="meta")
    names, leaves, _ = _tree.flatten_with_names(o["params"])
    assert names == _tree.flatten_with_names(mine)[0]
    for x, m in zip(leaves, _tree.tree_leaves(mine)):
        assert x.shape == m.shape and x.dtype == m.dtype


@pytest.mark.parametrize("aid", TIED)
def test_tied_forward_and_decode_match_reference(tied, aid):
    """``forward``'s logits, and ``DECODE_STEPS`` teacher-forced
    ``decode_step``s (recurrentgemma past its ring's wrap)."""
    o = tied[aid]
    cfg = o["cfg"]
    with torch.inference_mode():
        got = tt.forward(o["params"], {"tokens": o["batch"]["tokens"]}, cfg)
        _close(got, o["logits"])
        state = tt.init_decode_state(cfg, B, DECODE_STEPS, device="cpu")
        for t in range(DECODE_STEPS):
            lg, state = tt.decode_step(o["params"], state,
                                       o["batch"]["tokens"][:, t:t + 1], cfg)
            _close(lg, o["decode"][t])


@pytest.mark.parametrize("aid", TIED)
def test_tied_loss_and_gradients_match_reference(tied, aid):
    """The loss and every gradient leaf against ``jax.value_and_grad`` of
    the reference's loss. The ``embed`` leaf carries both uses: rows of
    tokens the batch never holds get the head's gradient alone (nonzero),
    and the whole leaf matches the reference's sum of the two."""
    from repro_torch.train.step import _value_and_grad
    o = tied[aid]
    loss, grads = _value_and_grad(o["params"], o["batch"], o["cfg"])
    np.testing.assert_allclose(float(loss), o["loss"], rtol=F32_TOL)
    errs = _grad_errs(grads, o["grads"])
    assert max(errs.values()) <= GRAD_TOL, sorted(
        errs.items(), key=lambda kv: -kv[1])[:3]
    seen = torch.unique(o["batch"]["tokens"])
    unseen = torch.ones(o["cfg"].vocab_size, dtype=torch.bool)
    unseen[seen] = False
    assert unseen.any() and bool(grads["embed"][unseen].abs().sum(-1).gt(
        0).all())


def _psa_rank(rank, world, dev, work):
    """One pod of two: ``make_psa_train_step``'s step on this pod's half of
    the batch, its reduced gradient caught where AdamW takes it."""
    from repro_torch.configs.base import PSAConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.psa_compress import psa_init
    from repro_torch.train import step as step_mod
    cfg = _cfg(tcfg, "qwen2-7b")
    params = torch.load(os.path.join(work, "params.pt"))
    batch = step_mod.shard_batch(torch.load(os.path.join(work, "batch.pt")),
                                 rank, world)
    pod = make_test_mesh(multi_pod=True, device=dev).axis("pod")
    psa, opt = PSAConfig(**PSA_CFG), AdamWConfig(warmup_steps=1)
    caught = {}
    inner = step_mod.adamw_update

    def catch(grads, *args, **kw):
        caught.update(embed=grads["embed"].clone())
        return inner(grads, *args, **kw)

    step_mod.adamw_update = catch
    step, _ = step_mod.make_psa_train_step(cfg, opt, psa, group=pod)
    _, _, _, met = step(params, adamw_init(params, opt),
                        psa_init(params, psa), batch)
    step_mod.adamw_update = inner
    return {"embed": caught["embed"], "loss": float(met["loss"])}


def test_psa_step_reduces_the_tied_head_share_of_embed(tied,
                                                       tmp_path_factory):
    """The PSA step over two pod ranks: the ``embed`` gradient it hands
    AdamW (dense, an f32 pod mean) holds the head's share, so it equals
    the reference's gradient of the global batch's loss; its loss is the
    global loss."""
    o = tied["qwen2-7b"]
    work = str(tmp_path_factory.mktemp("tied_psa"))
    torch.save(o["params"], os.path.join(work, "params.pt"))
    torch.save(o["batch"], os.path.join(work, "batch.pt"))
    ranks = spawn_ranks(_psa_rank, 2, backend="gloo", device="cpu",
                        args=(work,))
    want = o["grads"]["embed"]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], o["loss"], rtol=F32_TOL)
        err = float(np.abs(r["embed"].numpy() - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()), err


def test_tied_audio_head_is_refused():
    """musicgen-medium with a tied head: the reference's logits are
    ``None`` there and its reshape fails; the port raises ``ValueError``
    naming the cause, in ``init_params`` and in ``model_view``."""
    cfg = dataclasses.replace(
        tcfg.reduced_config(tcfg.get_arch("musicgen-medium")),
        tie_embeddings=True)
    with pytest.raises(ValueError, match="audio_codec"):
        tt.init_params(None, cfg, device="meta")
    with pytest.raises(ValueError, match="audio_codec"):
        shd.model_view(cfg, shd.MeshShape.of(("data", 2), ("model", 2)))
