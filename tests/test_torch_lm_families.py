"""The port's MoE, recurrent and frontend families against the reference's
(CPU): kimi-k2-1t-a32b and phi3.5-moe (MoE FFN), xlstm-1.3b (mLSTM /
sLSTM), recurrentgemma-2b (RG-LRU + sliding-window attention), paligemma-3b
(image patches spliced over the prefix) and musicgen-medium (four summed
codebooks, a (b, s, K, V) head), and the MoE's routing per data shard
(``act_specs["moe"]``); the flash kernel's plain version at their head dim
256 is in test_torch_flash_attention.py, their training in
test_torch_train_families.py.

Reduced configs in f32; parameters from the reference's ``init_params``,
carried across by ``interop.params_from_reference``; tokens and
activations drawn with numpy from a seed. Each reference run is jitted and
made once per architecture (module fixtures), so the file stays cheap.

Tolerances: F32_TOL = 2e-5 absolute and relative, both sides f32 with the
same operations summed in another order. RG-LRU's scan takes another tree
of the same combine (Hillis-Steele doubling here, the reference's
``associative_scan`` there), which reorders the f32 products and sums of
a recurrence of 32 steps: recurrentgemma's logits read 1.3e-5 at most
against it, inside F32_TOL, and the mixer alone reads ~1e-7. Decode
against the port's own prefill keeps the reference tests' 5e-2.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.data.pipeline import make_lm_batch as jmake_lm_batch
from repro.launch import analytic_cost as jcost
from repro.models import moe as jmoe
from repro.models import recurrent as jrec
from repro.models import transformer as jt
from repro_torch import configs as tcfg
from repro_torch import serve_decode
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.interop import params_from_reference
from repro_torch.launch import analytic_cost as tcost
from repro_torch.models import moe as tmoe
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as tt

F32_TOL = 2e-5
PARITY_TOL = 5e-2
FAMILIES = ("kimi-k2-1t-a32b", "phi3.5-moe-42b-a6.6b", "xlstm-1.3b",
            "recurrentgemma-2b", "paligemma-3b", "musicgen-medium")
B, S, DECODE_STEPS = 2, 32, 12
# recurrentgemma's window cut from the reduced 32 to 8, so that the decode
# steps run its sliding-window ring past the window
OVERRIDES = {"recurrentgemma-2b": dict(window=8)}


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _cfgs(aid, **overrides):
    return (jcfg.reduced_config(jcfg.get_arch(aid), **overrides),
            tcfg.reduced_config(tcfg.get_arch(aid), **overrides))


@pytest.fixture(scope="module")
def family():
    """aid -> the reference's run of a reduced config (params, batch,
    forward logits, DECODE_STEPS decode logits) and the port's params."""
    cache = {}

    def get(aid):
        if aid not in cache:
            jc, tc = _cfgs(aid, **OVERRIDES.get(aid, {}))
            params = jt.init_params(jax.random.PRNGKey(0), jc)
            batch = jax.tree.map(np.asarray, jmake_lm_batch(jc, 0, 0, B, S))
            batch.pop("labels")
            fwd = jax.jit(lambda p, bt: jt.forward(p, bt, jc, remat=False))
            logits = np.asarray(fwd(params, batch))
            step = jax.jit(lambda p, s, t: jt.decode_step(p, s, t, jc))
            state = jt.init_decode_state(jc, B, DECODE_STEPS)
            decoded = []
            for t in range(DECODE_STEPS):
                lg, state = step(params, state,
                                 batch["tokens"][:, t:t + 1])
                decoded.append(np.asarray(lg))
            cache[aid] = dict(
                jc=jc, tc=tc, params=params, batch=batch, logits=logits,
                decoded=decoded, state=jax.tree.map(np.asarray, state),
                tparams=params_from_reference(
                    jax.tree.map(np.asarray, params), "cpu"))
        return cache[aid]
    return get


def _shapes(tree, prefix=""):
    """path -> (shape, dtype name) of every leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    name = str(tree.dtype).replace("torch.", "")
    return {prefix: (tuple(tree.shape), name)}


# ---------------------------------------------------------------------------
# the stack, architecture by architecture
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aid", FAMILIES)
def test_init_params_tree_matches_reference(aid, dtype):
    """Keys, shapes and dtypes leaf for leaf: the f32 MoE router and
    RG-LRU ``lam`` stay f32 in a bf16 model."""
    jc, tc = _cfgs(aid, dtype=dtype)
    want = jax.eval_shape(lambda k: jt.init_params(k, jc),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert _shapes(tt.init_params(None, tc, device="meta")) == _shapes(want)


@pytest.mark.parametrize("aid", FAMILIES)
def test_forward_matches_reference(aid, family):
    f = family(aid)
    got = tt.forward(f["tparams"], {k: torch.from_numpy(v)
                                    for k, v in f["batch"].items()}, f["tc"])
    want_shape = (B, S, f["tc"].n_codebooks, f["tc"].vocab_size) \
        if f["tc"].frontend == "audio_codec" else (B, S, f["tc"].vocab_size)
    assert tuple(got.shape) == want_shape
    _close(got, f["logits"])


@pytest.mark.parametrize("aid", FAMILIES)
def test_decode_step_matches_reference(aid, family):
    f = family(aid)
    tc = f["tc"]
    state = tt.init_decode_state(tc, B, DECODE_STEPS, device="cpu")
    toks = f["batch"]["tokens"]
    for t in range(DECODE_STEPS):
        got, state = tt.decode_step(f["tparams"], state,
                                    torch.from_numpy(toks[:, t:t + 1]), tc)
        _close(got, f["decoded"][t])
    assert state["index"] == DECODE_STEPS
    _close_tree(state["caches"], f["state"]["caches"])


def _close_tree(got, want):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            _close_tree(got[key], want[key])
        else:
            _close(got[key], want[key])


@pytest.mark.parametrize("aid", FAMILIES)
def test_decode_matches_prefill(aid):
    """Twin of test_models_smoke.py::test_decode_matches_prefill on the
    port alone. As there, MoE capacity is raised so that nothing drops, and
    the VLM runs on a pure token stream."""
    tc = tcfg.reduced_config(tcfg.get_arch(aid))
    if tc.moe is not None:
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=64.0))
    params = tt.init_params(torch.Generator().manual_seed(0), tc,
                            device="cpu")
    toks = make_lm_batch(tc, 0, 0, B, S, device="cpu")["tokens"][:, :12]
    want = tt.forward(params, {"tokens": toks}, tc)
    state = tt.init_decode_state(tc, B, 12, device="cpu")
    outs = []
    for t in range(12):
        lg, state = tt.decode_step(params, state, toks[:, t:t + 1], tc)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, dim=1), want, rtol=PARITY_TOL,
                               atol=PARITY_TOL)


def test_hybrid_swa_ring_past_its_window(family):
    """recurrentgemma's sliding-window layers decode from a ring of the
    window (8 slots) over 24 tokens, beside their RG-LRU states, and match
    windowed prefill (the first 12 steps match the reference's decode:
    test_decode_step_matches_reference)."""
    f = family("recurrentgemma-2b")
    tc = f["tc"]
    assert tc.window == 8
    toks = make_lm_batch(tc, 0, 0, 1, 24, device="cpu")["tokens"]
    want = tt.forward(f["tparams"], {"tokens": toks}, tc)
    state = tt.init_decode_state(tc, 1, 24, device="cpu")
    assert state["caches"]["blk2_swa"]["k"].shape[3] == 8
    assert state["caches"]["blk0_rglru"]["conv"].shape == (1, 1, 3, 64)
    outs = []
    for t in range(24):
        lg, state = tt.decode_step(f["tparams"], state, toks[:, t:t + 1], tc)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, dim=1), want, rtol=PARITY_TOL,
                               atol=PARITY_TOL)


def test_vlm_patches_are_spliced_over_the_prefix(family):
    """paligemma's first n_prefix_tokens positions come from patch_embeds,
    whatever the tokens there; the rest from the tokens."""
    f = family("paligemma-3b")
    tc, tp = f["tc"], f["tparams"]
    batch = {k: torch.from_numpy(v) for k, v in f["batch"].items()}
    x = tt.embed_inputs(tp, batch, tc)
    npfx = tc.n_prefix_tokens
    assert torch.equal(x[:, :npfx], batch["patch_embeds"])
    other = dict(batch, tokens=batch["tokens"].clone())
    other["tokens"][:, :npfx] = 0
    assert torch.equal(tt.embed_inputs(tp, other, tc), x)
    assert torch.equal(x[:, npfx:], tp["embed"][batch["tokens"][:, npfx:]])


# ---------------------------------------------------------------------------
# MoE routing with drops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("aid", ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"])
def test_apply_moe_with_drops_matches_reference(aid, family):
    """capacity_factor 0.5 over 64 tokens: cap 16 slots an expert for 32
    (token, choice) pairs each on average, so pairs drop. The kept mask and
    the slots equal the reference's; the output (kimi with its shared
    expert) within F32_TOL."""
    f = family(aid)
    jc = dataclasses.replace(f["jc"], moe=dataclasses.replace(
        f["jc"].moe, capacity_factor=0.5))
    tc = dataclasses.replace(f["tc"], moe=dataclasses.replace(
        f["tc"].moe, capacity_factor=0.5))
    p = jax.tree.map(lambda l: l[0], f["params"]["groups"]["blk0_attn"]["ffn"])
    tp = tt.tree_map(lambda l: l[0], f["tparams"]["groups"]["blk0_attn"]
                     ["ffn"])
    assert ("shared" in tp) == (aid == "kimi-k2-1t-a32b")
    x = np.random.default_rng(5).standard_normal((4, 16, jc.d_model)).astype(
        np.float32)
    cap = tmoe.moe_capacity(tc.moe, 64)
    assert cap == jmoe.moe_capacity(jc.moe, 64) == 16
    gates, keep, slot = jax.jit(lambda xf, r: jmoe._route_shard(
        xf, r, jc.moe, cap))(x.reshape(64, -1), p["router"])
    tgates, tkeep, tslot = tmoe.route(torch.from_numpy(x.reshape(64, -1)),
                                      tp["router"], tc.moe, cap)
    assert not bool(np.asarray(keep).all())                 # drops happen
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(slot))
    _close(tgates, gates)
    _close(tmoe.apply_moe(tp, torch.from_numpy(x), tc),
           jax.jit(lambda pp, xx: jmoe.apply_moe(pp, xx, jc))(p, x))


# (tokens (b, s), capacity factor): 64 tokens at the config's 1.25, the
# same at 0.5 where per-shard capacities drop other pairs than one global
# routing, and 15 tokens that divide over no shard count here (routed as one
# shard, tests/test_perf_features.py's fallback)
SHARD_CASES = {"even": ((4, 16), None), "tight": ((4, 16), 0.5),
               "indivisible": ((3, 5), None)}


@pytest.mark.parametrize("case", list(SHARD_CASES))
@pytest.mark.parametrize("n_dp", [2, 4])
def test_shard_local_moe_matches_reference(n_dp, case, family):
    """``act_specs["moe"]`` routes each data shard's tokens on their own,
    with a capacity a (shard, expert): the output equals the reference's
    ``apply_moe`` with the same spec within F32_TOL; at the tight
    capacity it differs from global routing."""
    f = family("phi3.5-moe-42b-a6.6b")
    (b, s), cf = SHARD_CASES[case]
    jc, tc = f["jc"], f["tc"]
    if cf is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=cf))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=cf))
    p = jax.tree.map(lambda l: l[0], f["params"]["groups"]["blk0_attn"]["ffn"])
    tp = tt.tree_map(lambda l: l[0], f["tparams"]["groups"]["blk0_attn"]
                     ["ffn"])
    x = np.random.default_rng(7).standard_normal((b, s, jc.d_model)).astype(
        np.float32)
    spec = {"moe": {"dp": None, "e": None, "n_dp": n_dp}}
    want = jax.jit(lambda pp, xx: jmoe.apply_moe(pp, xx, jc,
                                                 act_specs=spec))(p, x)
    got = tmoe.apply_moe(tp, torch.from_numpy(x), tc, act_specs=spec)
    _close(got, want)
    glob = tmoe.apply_moe(tp, torch.from_numpy(x), tc)
    if case == "tight":
        assert float((got - glob).abs().max()) > 1e-2
    else:
        _close(got, glob.numpy())


# ---------------------------------------------------------------------------
# the recurrent mixers, full sequence and one step
# ---------------------------------------------------------------------------
MIXERS = {"mlstm": ("xlstm-1.3b", "blk0_mlstm"),
          "slstm": ("xlstm-1.3b", "blk1_slstm"),
          "rglru": ("recurrentgemma-2b", "blk0_rglru")}


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_full_and_one_step_match_reference(kind, family):
    aid, name = MIXERS[kind]
    f = family(aid)
    jc, tc = f["jc"], f["tc"]
    p = jax.tree.map(lambda l: l[0], f["params"]["groups"][name]["mixer"])
    tp = tt.tree_map(lambda l: l[0], f["tparams"]["groups"][name]["mixer"])
    japply = jax.jit(lambda pp, xx, st: getattr(jrec, f"apply_{kind}")(
        pp, xx, jc, state=st))
    tapply = getattr(trec, f"apply_{kind}")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    want, wstate = japply(p, x, None)
    got, gstate = tapply(tp, torch.from_numpy(x), tc)
    _close(got, want)
    _close_tree(gstate, jax.tree.map(np.asarray, wstate))
    # one step from a state that is not zero: the full path's final state
    x1 = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    want, wstate = japply(p, x1, wstate)
    got, gstate = tapply(tp, torch.from_numpy(x1), tc, state=gstate)
    _close(got, want)
    _close_tree(gstate, jax.tree.map(np.asarray, wstate))


def test_linear_scan_is_the_recurrence_at_the_gate_range():
    """Hillis-Steele against the step-by-step recurrence, float64, with
    log a down to -8 softplus(8) = -64 a step, where exp(cumsum(log a))
    underflows to 0 and its quotient to NaN; odd length."""
    rng = np.random.default_rng(7)
    log_a = -64.0 * rng.uniform(0, 1, (2, 37, 5))
    a = torch.from_numpy(np.exp(log_a))
    b = torch.from_numpy(rng.standard_normal((2, 37, 5)))
    h = torch.zeros(2, 5, dtype=torch.float64)
    want = []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = trec.linear_scan(a, b)
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# param counts, the analytic cost model, the serve_decode twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("aid", jcfg.ARCH_IDS)
def test_active_param_count_matches_reference(aid):
    """Parameters a token touches (MoE: top-k and shared experts only); the
    full counts are test_torch_models.py's."""
    assert tcfg.get_arch(aid).active_param_count() == jcfg.get_arch(
        aid).active_param_count()


def test_analytic_cost_matches_reference_on_every_cell():
    cells = jcfg.valid_cells()
    assert len(cells) == 40
    for cell in cells:
        want = jcost.analytic_cost(jcfg.get_arch(cell["arch"]),
                                   jcfg.get_shape(cell["shape"]))
        got = tcost.analytic_cost(tcfg.get_arch(cell["arch"]),
                                  tcfg.get_shape(cell["shape"]))
        assert got == want, cell
    assert tcost.straggler_slowdown(n_nodes=8, t_step=1.0, delay=0.5,
                                    synchronous=False) == \
        jcost.straggler_slowdown(n_nodes=8, t_step=1.0, delay=0.5,
                                 synchronous=False)


def test_serve_decode_twin_ends_ok(capsys):
    """``python -m repro_torch.serve_decode --device cpu``: both models
    generate (BATCH, GEN) tokens, as examples/serve_decode.py does."""
    gens = serve_decode.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    assert set(gens) == {"qwen2-7b", "recurrentgemma-2b"}
    for aid, gen in gens.items():
        cfg = tcfg.reduced_config(tcfg.get_arch(aid))
        assert tuple(gen.shape) == (serve_decode.BATCH, serve_decode.GEN)
        assert int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size
        shape = rf"\({serve_decode.BATCH}, {serve_decode.GEN}\)"
        assert re.search(rf"{re.escape(aid)}\s+generated {shape} tokens", out)
