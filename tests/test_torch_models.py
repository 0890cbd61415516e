"""The port's LM serving stack against the reference's (CPU): configs and
the parameter count of every architecture, layers, attention (prefill and
decode, bf16 and int8 caches), ``forward`` and ``decode_step`` on reduced
dense-attention configs (the other families: test_torch_lm_families.py).

Parameters come from the reference's ``init_params`` and cross over with
``interop.params_from_reference``; tokens and activations are drawn with
numpy from a seed and handed to both packages.

Tolerances: the reduced configs compute in f32 on both sides, so outputs
agree to 2e-5 absolute and relative (matmuls and softmax sums in another
order). bf16 layer checks allow one bf16 ulp of the largest output, 2^-7 of
max |out|. The decode-vs-prefill twins keep the reference tests' own 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.data.pipeline import make_lm_batch as jmake_lm_batch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro_torch import configs as tcfg
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.interop import params_from_reference
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt

F32_TOL = 2e-5
BF16_TOL = 2.0 ** -7
PARITY_TOL = 5e-2          # test_models_smoke.py's decode-vs-prefill tolerance
DENSE = ("qwen2-7b", "internlm2-20b", "h2o-danube-1.8b", "command-r-35b")


def _cfgs(aid, **overrides):
    return (jcfg.reduced_config(jcfg.get_arch(aid), **overrides),
            tcfg.reduced_config(tcfg.get_arch(aid), **overrides))


def _params(jc):
    params = jt.init_params(jax.random.PRNGKey(0), jc)
    return params, params_from_reference(jax.tree.map(np.asarray, params),
                                         "cpu")


def _tokens(seed, vocab, b, s):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_registry_matches_reference():
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    assert tcfg.valid_cells() == jcfg.valid_cells()
    assert dataclasses.asdict(tcfg.get_psa_config()) == dataclasses.asdict(
        jcfg.get_psa_config())
    for sid in jcfg.SHAPES:
        assert dataclasses.asdict(tcfg.get_shape(sid)) == dataclasses.asdict(
            jcfg.get_shape(sid))


@pytest.mark.parametrize("aid", jcfg.ARCH_IDS)
def test_configs_and_reduced_configs_match_reference(aid):
    assert dataclasses.asdict(tcfg.get_arch(aid)) == dataclasses.asdict(
        jcfg.get_arch(aid))
    jc, tc = _cfgs(aid)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.torch_dtype == torch.float32


@pytest.mark.parametrize("aid", jcfg.ARCH_IDS)
def test_param_count_matches_reference(aid):
    """Counted on the meta device; qwen2-7b is 7,615,616,512 parameters,
    kimi-k2-1t-a32b 1,044,860,859,392."""
    assert tcfg.get_arch(aid).param_count() == jcfg.get_arch(
        aid).param_count()
    jc, tc = _cfgs(aid)
    assert tc.param_count() == jc.param_count()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    rng = np.random.default_rng(0)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    x = rng.standard_normal((2, 3, 12, 32)).astype(np.float32)
    gamma = rng.standard_normal(32).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 12)).astype(np.int32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))

    def check(got, want):
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())

    check(tlayers.rms_norm(tx, torch.from_numpy(gamma), 1e-6),
          jlayers.rms_norm(jx, jnp.asarray(gamma), 1e-6))
    for theta in (1e4, 1e6):
        check(tlayers.rope(tx, torch.from_numpy(pos), theta),
              jlayers.rope(jx, jnp.asarray(pos), theta))
    check(tlayers.rope(tx, torch.from_numpy(pos[0]), 1e4),
          jlayers.rope(jx, jnp.asarray(pos[0]), 1e4))
    w = [rng.standard_normal(s).astype(np.float32) * 0.2
         for s in ((32, 48), (32, 48), (48, 32))]
    check(tlayers.swiglu_ffn(tx, *[torch.from_numpy(a).to(tx.dtype)
                                   for a in w]),
          jlayers.swiglu_ffn(jx, *[jnp.asarray(a).astype(dtype) for a in w]))
    emb = rng.standard_normal((50, 16)).astype(np.float32)
    check(tlayers.embed_lookup(torch.from_numpy(emb), torch.from_numpy(pos % 50)),
          jlayers.embed_lookup(jnp.asarray(emb), jnp.asarray(pos % 50)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_quant", [False, True])
def test_apply_attn_prefill_and_decode_match_reference(kv_quant):
    jc, tc = _cfgs("qwen2-7b", kv_quant=kv_quant)
    params, tparams = _params(jc)
    p = jax.tree.map(lambda l: l[0], params["groups"]["blk0_attn"]["mixer"])
    tp = {k: v[0] for k, v in tparams["groups"]["blk0_attn"]["mixer"].items()}
    x = np.random.default_rng(1).standard_normal((2, 24, jc.d_model)).astype(
        np.float32)
    for use in (False, True):
        want, _ = jattn.apply_attn(p, jnp.asarray(x), jc, use_pallas=use)
        got, cache = tattn.apply_attn(tp, torch.from_numpy(x), tc,
                                      use_kernel=use)
        assert cache is None
        _close(got, want)
    jcache = jax.tree.map(lambda l: l[0],
                          jattn.init_kv_cache(jc, 2, 16, 1))
    tcache = {k: v[0] for k, v in tattn.init_kv_cache(
        tc, 2, 16, 1, torch.device("cpu")).items()}
    for t in range(20):              # past 16 the ring buffer wraps
        want, jcache = jattn.apply_attn(p, jnp.asarray(x[:, t:t + 1]), jc,
                                        cache=jcache, cache_index=t)
        got, tcache = tattn.apply_attn(tp, torch.from_numpy(x[:, t:t + 1]),
                                       tc, cache=tcache, cache_index=t)
        _close(got, want)
        for key in jcache:
            # an int8 code may land one step off where x / scale * 127 sits
            # within f32 rounding of a .5 boundary
            code = kv_quant and key in ("k", "v")
            np.testing.assert_allclose(tcache[key].float().numpy(),
                                       np.asarray(jcache[key], np.float32),
                                       rtol=F32_TOL,
                                       atol=1 if code else F32_TOL)


@pytest.mark.parametrize("window", [None, 20])
def test_blockwise_attention_matches_reference(window):
    rng = np.random.default_rng(2)
    q, k, v = [rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
               for _ in range(3)]
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                     window=window, q_chunk=16, k_chunk=32)
    got = tattn.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                    window=window, q_chunk=16, k_chunk=32)
    _close(got, want)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("aid", DENSE)
def test_forward_matches_reference(aid, use_kernel):
    """S = 256, so the reference's use_pallas=True runs its interpret-mode
    Pallas kernel (two 128-row blocks), not its below-one-block oracle."""
    jc, tc = _cfgs(aid, n_layers=2)
    params, tparams = _params(jc)
    toks = _tokens(3, jc.vocab_size, 2, 256)
    want = jt.forward(params, {"tokens": jnp.asarray(toks)}, jc, remat=False,
                      use_pallas=use_kernel)
    got = tt.forward(tparams, {"tokens": torch.from_numpy(toks)}, tc,
                     use_kernel=use_kernel)
    assert got.shape == (2, 256, jc.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("aid", DENSE)
def test_decode_step_matches_reference(aid, kv_quant):
    jc, tc = _cfgs(aid, n_layers=2, kv_quant=kv_quant,
                   **({"window": 8} if aid == "h2o-danube-1.8b" else {}))
    params, tparams = _params(jc)
    toks = _tokens(4, jc.vocab_size, 2, 12)
    jstate = jt.init_decode_state(jc, 2, 12)
    tstate = tt.init_decode_state(tc, 2, 12, device="cpu")
    for t in range(12):
        want, jstate = jt.decode_step(params, jstate,
                                      jnp.asarray(toks[:, t:t + 1]), jc)
        got, tstate = tt.decode_step(tparams, tstate,
                                     torch.from_numpy(toks[:, t:t + 1]), tc)
        _close(got, want)
    assert tstate["index"] == int(jstate["index"]) == 12


def _teacher_forced(params, cfg, toks, max_len):
    state = tt.init_decode_state(cfg, toks.shape[0], max_len, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        lg, state = tt.decode_step(params, state, toks[:, t:t + 1], cfg)
        outs.append(lg)
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("aid", DENSE)
def test_decode_matches_prefill(aid):
    """Twin of test_models_smoke.py::test_decode_matches_prefill on the
    port alone: teacher-forced decode reproduces the forward logits."""
    tc = tcfg.reduced_config(tcfg.get_arch(aid))
    params = tt.init_params(torch.Generator().manual_seed(0), tc,
                            device="cpu")
    toks = make_lm_batch(tc, 0, 0, 2, 32, device="cpu")["tokens"][:, :12]
    want = tt.forward(params, {"tokens": toks}, tc)
    got = _teacher_forced(params, tc, toks, 12)
    torch.testing.assert_close(got, want, rtol=PARITY_TOL, atol=PARITY_TOL)


def test_swa_decode_ring_buffer():
    """Twin of test_models_smoke.py::test_swa_decode_ring_buffer: a window
    cache shorter than the sequence matches windowed prefill."""
    tc = tcfg.reduced_config(tcfg.get_arch("h2o-danube-1.8b"), window=8)
    params = tt.init_params(torch.Generator().manual_seed(0), tc,
                            device="cpu")
    toks = make_lm_batch(tc, 0, 0, 1, 24, device="cpu")["tokens"]
    want = tt.forward(params, {"tokens": toks}, tc)
    state = tt.init_decode_state(tc, 1, 24, device="cpu")
    assert state["caches"]["blk0_swa"]["k"].shape[3] == 8
    got = _teacher_forced(params, tc, toks, 24)
    torch.testing.assert_close(got, want, rtol=PARITY_TOL, atol=PARITY_TOL)


# ---------------------------------------------------------------------------
# data and interop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("aid", ["qwen2-7b", "musicgen-medium",
                                 "paligemma-3b"])
def test_make_lm_batch_shapes_and_labels(aid):
    jc, tc = _cfgs(aid)
    want = jax.tree.map(np.asarray, jmake_lm_batch(jc, 0, 3, 2, 16))
    got = make_lm_batch(tc, 0, 3, 2, 16, device="cpu")
    again = make_lm_batch(tc, 0, 3, 2, 16, device="cpu")
    other = make_lm_batch(tc, 0, 4, 2, 16, device="cpu")
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert torch.equal(got[key], again[key])
    assert got["tokens"].dtype == torch.int32
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    assert not torch.equal(got["tokens"], other["tokens"])
    assert int(got["tokens"].min()) >= 0
    assert int(got["tokens"].max()) < tc.vocab_size


def test_params_from_reference_carries_bf16_exactly():
    jc = jcfg.reduced_config(jcfg.get_arch("qwen2-7b"), dtype="bfloat16")
    params = jt.init_params(jax.random.PRNGKey(0), jc)
    arrays = jax.tree.map(np.asarray, params)
    tparams = params_from_reference(arrays, "cpu")

    def walk(got, want):
        if isinstance(want, dict):
            assert set(got) == set(want)
            for key in want:
                walk(got[key], want[key])
            return
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert np.array_equal(got.float().numpy(), want.astype(np.float32))

    walk(tparams, arrays)
    as_f32 = params_from_reference(arrays, "cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in tt.tree_leaves(as_f32))
