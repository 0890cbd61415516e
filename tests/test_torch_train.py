"""The training side (CPU): the port's AdamW, PSA compression, loss, train
steps and training driver against the reference's, on the same inputs.

The reference runs once, in one subprocess with 8 placeholder XLA devices
(tests/test_spmd.py's pattern): AdamW on the cases of
tests/test_optim_psa.py, ``compress_grads`` / ``psa_refresh`` with no pod
axis, ``_ring_gossip`` and ``psa_refresh`` over a 4-pod and a 2-pod
``shard_map``, ``loss_fn`` and one train step on reduced qwen2-7b (f32),
and the PSA train step (step, refresh, step) on its 4-device multipod mesh.
It writes its inputs (parameters, batch, projectors) and outputs to an npz;
the port reads the same inputs. The port's ranks are spawned twice (4
ranks, then 2), gloo on the CPU. The 2-rank spawn also runs the training
driver for 6 steps against 3 steps and a resumed 3 (bit for bit), and the
example twin at a few steps. This file imports no JAX.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced_config
from repro_torch.configs.base import PSAConfig
from repro_torch.interop import params_from_reference
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.psa_compress import (compress_grads, compressible,
                                            compression_ratio, psa_init,
                                            psa_refresh)
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.train.step import loss_fn, make_train_step

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# one pod's gradient and entering projector at the step-32 refresh of the
# example's --full-100m run on an H100, where the reference's one-pass
# refresh breaks down (tools/refresh_breakdown_capture.py)
BREAKDOWN = os.path.join(os.path.dirname(__file__), "data",
                         "psa_refresh_breakdown.npz")
ADAMW_TOL = 1e-6      # f32 elementwise, relative to max |reference|
PSA_TOL = 1e-5        # f32 matmuls summed in another order
# a whole forward / backward / update, relative. Parameters after AdamW
# are held to STEP_TOL of the largest parameter: a first step moves each
# element by about lr whatever the size of its gradient, so an element
# whose gradient is rounding noise moves by a noisy fraction of lr (the
# key bias in the dims RoPE barely turns over 8 positions: softmax ignores
# a shift shared by all keys, so its gradient there nearly vanishes)
STEP_TOL = 1e-4
COMPRESS_SHAPES = {"w": (64, 16), "g": (3, 32, 8), "scale": (16,),
                   "embed": (64, 32), "small": (8, 32)}
PSA_CFG = dict(rank=4, oi_iters=2, gossip_rounds=2)
ADAMW_CASES = ["quadratic", "clip", "bf16_moments", "warmup", "tree"]

REFERENCE = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import get_arch, reduced_config
    from repro.configs.base import PSAConfig
    from repro.core.compat import shard_map
    from repro.data.pipeline import make_lm_batch
    from repro.launch.mesh import make_test_mesh
    from repro.models.transformer import init_params
    from repro.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro.optim.psa_compress import (_ring_gossip, compress_grads,
                                          compressible, compression_ratio,
                                          psa_init, psa_refresh)
    from repro.train.step import _train_step, make_psa_train_step

    out = {}
    # jitted, the same math as the eager calls, in a fraction of the time
    adamw_update = jax.jit(adamw_update, static_argnums=(3,))
    compress_grads = jax.jit(compress_grads, static_argnums=(2,),
                             static_argnames="pod_axis")
    psa_refresh_nopod = jax.jit(psa_refresh, static_argnums=(2,),
                                static_argnames="pod_axis")

    def put(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                put(f"{prefix}/{k}", v)
        elif tree is not None:
            a = np.asarray(tree)
            out[prefix] = a.astype(np.float32) if a.dtype.name == "bfloat16" \\
                else a

    def put_pods(prefix, tree, pod_devices):
        # a replicated output of shard_map holds each pod's own value
        if isinstance(tree, dict):
            for k, v in tree.items():
                put_pods(f"{prefix}/{k}", v, pod_devices)
        elif tree is not None:
            # XLA may split a leaf over the auto "model" axis: assemble
            # each pod's copy from its devices' pieces
            for i, devs in enumerate(pod_devices):
                full = np.zeros(tree.shape, np.float32)
                for s in tree.addressable_shards:
                    if s.device.id in devs:
                        full[s.index] = np.asarray(s.data)
                out[f"{prefix}@{i}"] = full

    rng = np.random.default_rng(0)
    # AdamW: tests/test_optim_psa.py's cases, each a few recorded steps
    w = rng.standard_normal((8, 8)).astype(np.float32)
    cases = {
        "quadratic": ({"w": np.zeros((8, 8), np.float32)},
                      AdamWConfig(lr=5e-2, weight_decay=0.0, warmup_steps=1),
                      None, 300),
        "clip": ({"w": np.zeros((4,), np.float32)},
                 AdamWConfig(grad_clip=1.0, warmup_steps=1),
                 [{"w": np.full((4,), 1e6, np.float32)}], 1),
        "bf16_moments": ({"w": np.zeros((16, 16), np.float32)},
                         AdamWConfig(moment_dtype="bfloat16"),
                         [{"w": np.ones((16, 16), np.float32)}] * 3, 3),
        "warmup": ({"w": np.zeros((), np.float32)},
                   AdamWConfig(lr=1.0, warmup_steps=10, weight_decay=0.0),
                   [{"w": np.ones((), np.float32)}] * 3, 3),
        "tree": ({"a": rng.standard_normal((5, 7)).astype(np.float32),
                  "b": {"c": rng.standard_normal((3,)).astype(np.float32)}},
                 AdamWConfig(warmup_steps=2, moment_dtype="bfloat16"),
                 [{"a": rng.standard_normal((5, 7)).astype(np.float32),
                   "b": {"c": rng.standard_normal((3,)).astype(np.float32)}}
                  for _ in range(4)], 4),
    }
    for name, (p0, opt, grads, steps) in cases.items():
        put(f"adamw/{name}/p0", p0)
        params = jax.tree.map(jnp.asarray, p0)
        state = adamw_init(params, opt)
        for t in range(steps):
            if grads is None:      # the quadratic's gradient 2 (w - w*)
                g = {"w": 2.0 * (params["w"] - w)}
            else:
                g = jax.tree.map(jnp.asarray, grads[t])
                put(f"adamw/{name}/g{t}", grads[t])
            params, state, gnorm = adamw_update(g, state, params, opt)
            if t in (0, 1, 9, steps - 1):
                put(f"adamw/{name}/p{t + 1}", params)
                put(f"adamw/{name}/m{t + 1}", state["m"])
                put(f"adamw/{name}/v{t + 1}", state["v"])
                out[f"adamw/{name}/gnorm{t + 1}"] = np.asarray(gnorm)
    out["adamw/quadratic/target"] = w

    # PSA with no pod axis
    cfg_c = PSAConfig(rank=4, oi_iters=5, error_feedback=True)
    shapes = %(shapes)r
    gs = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    put("psa/g", gs)
    jg = jax.tree.map(jnp.asarray, gs)
    st = psa_init(jg, cfg_c)
    put("psa/proj", st["proj"])
    red, ef = compress_grads(jg, st, cfg_c, pod_axis=None)
    put("psa/red", red)
    put("psa/ef", ef)
    red2, ef2 = compress_grads(jg, {"proj": st["proj"], "ef": ef}, cfg_c,
                               pod_axis=None)
    put("psa/red2", red2)
    put("psa/ef2", ef2)
    put("psa/refresh",
        psa_refresh_nopod(jg, st, cfg_c, pod_axis=None)["proj"])
    # an ill-conditioned gradient (singular values 10^(-k/3)): one
    # CholeskyQR pass breaks down in f32
    u_ill = np.linalg.qr(rng.standard_normal((256, 64)))[0]
    v_ill = np.linalg.qr(rng.standard_normal((64, 64)))[0]
    g_ill = ((u_ill * 10.0 ** (-np.arange(64) / 3)) @ v_ill.T).astype(
        np.float32)
    out["ill/g"] = g_ill
    cfg_i = PSAConfig(rank=8, oi_iters=1)
    st_i = psa_init({"w": jnp.asarray(g_ill)}, cfg_i)
    put("ill/proj", st_i["proj"])
    put("ill/new", psa_refresh_nopod({"w": jnp.asarray(g_ill)}, st_i, cfg_i,
                                     pod_axis=None)["proj"])
    # a gradient from the example's own trajectory (BREAKDOWN)
    traj = np.load(%(breakdown)r)
    cfg_t = PSAConfig(rank=int(traj["rank"]), oi_iters=int(traj["oi_iters"]))
    out["traj/new"] = np.asarray(psa_refresh_nopod(
        {"w": jnp.asarray(traj["g"])},
        {"proj": {"w": jnp.asarray(traj["proj"])}, "ef": {"w": None}},
        cfg_t, pod_axis=None)["proj"]["w"])
    out["psa/compressible"] = np.array(
        [compressible(jnp.zeros(s), r) for s in
         [(64, 32), (8, 32), (64,), (16, 4), (16, 3), (2, 16, 8)]
         for r in (1, 4)])

    # ring gossip and refresh over 4 pods, and over 2 pods
    psa = PSAConfig(**%(psa_cfg)r)
    devs = np.array(jax.devices()[:4])
    for pods in (4, 2):
        mesh = Mesh(devs.reshape(pods, 4 // pods), ("pod", "data"))
        z = rng.standard_normal((pods, 32, 4)).astype(np.float32)
        out[f"ring{pods}/z"] = z
        got = jax.jit(shard_map(
            lambda zz: _ring_gossip(zz[0], "pod", 3, pods)[None],
            mesh=mesh, in_specs=(P("pod"),), out_specs=P("pod")))(z)
        out[f"ring{pods}/out"] = np.asarray(got)
        gp = {"w": rng.standard_normal((pods, 64, 16)).astype(np.float32),
              "s": rng.standard_normal((pods, 2, 32, 8)).astype(np.float32)}
        put(f"ring{pods}/g", gp)
        st = psa_init({"w": jnp.zeros((64, 16)),
                       "s": jnp.zeros((2, 32, 8))}, psa)
        put(f"ring{pods}/proj", st["proj"])
        def refresh(g):
            new = psa_refresh({k: v[0] for k, v in g.items()}, st, psa,
                              pod_axis="pod")
            return {k: v[None] for k, v in new["proj"].items()}
        new = jax.jit(shard_map(refresh, mesh=mesh,
                                in_specs=({"w": P("pod"), "s": P("pod")},),
                                out_specs={"w": P("pod"), "s": P("pod")}))(
            jax.tree.map(jnp.asarray, gp))
        put(f"ring{pods}/new", new)

    # loss and one train step on reduced qwen2-7b
    cfg = reduced_config(get_arch("qwen2-7b"))
    params = init_params(jax.random.PRNGKey(0), cfg)
    batch = make_lm_batch(cfg, 0, 0, 4, 8)
    put("lm/params", params)
    put("lm/batch", batch)
    opt = AdamWConfig(warmup_steps=1)
    train_step = jax.jit(lambda p, o, b: _train_step(p, o, b, cfg, opt,
                                                     False, False))
    p1, _, m1 = train_step(params, adamw_init(params, opt), batch)
    put("lm/step_params", p1)
    out["lm/loss"] = np.asarray(m1["loss"])       # loss_fn of params
    out["lm/step_gnorm"] = np.asarray(m1["grad_norm"])
    out["lm/ratio"] = np.asarray(compression_ratio(params, psa))

    # the PSA train step on the 4-device multipod mesh: step, refresh, step
    mesh = make_test_mesh(jax.devices()[:4], multi_pod=True)
    pod_devices = [[int(d.id) for d in mesh.devices[i].reshape(-1)]
                   for i in range(2)]
    psa_state = psa_init(params, psa)
    put("train/proj0", psa_state["proj"])
    step_fn, refresh_fn, _ = make_psa_train_step(cfg, mesh, opt, psa,
                                                 global_batch=4)
    with mesh:
        p1, o1, ps1, met1 = step_fn(params, adamw_init(params, opt),
                                    psa_state, batch)
        ps2 = refresh_fn(p1, ps1, batch)
        p2, o2, ps3, met2 = step_fn(p1, o1, ps2, batch)
    for k, (p_, met) in enumerate(((p1, met1), (p2, met2)), 1):
        put(f"train/params{k}", p_)
        out[f"train/loss{k}"] = np.asarray(met["loss"])
        out[f"train/gnorm{k}"] = np.asarray(met["grad_norm"])
    put_pods("train/ef1", ps1["ef"], pod_devices)
    put_pods("train/ef2", ps3["ef"], pod_devices)
    put("train/proj1", ps2["proj"])
    np.savez(sys.argv[1], **out)
""" % {"shapes": COMPRESS_SHAPES, "psa_cfg": PSA_CFG,
       "breakdown": BREAKDOWN}


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("train_ref") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        path], capture_output=True, text=True, timeout=420,
                       env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return path


@pytest.fixture(scope="module")
def ref(ref_path):
    return dict(np.load(ref_path))


def tree(ref, prefix, suffix=""):
    """The nested dict of arrays saved under ``prefix/...``."""
    out = {}
    for key, val in ref.items():
        if not key.startswith(prefix + "/") or not key.endswith(suffix):
            continue
        path = key[len(prefix) + 1:len(key) - len(suffix)].split("/")
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = val
    return out


def tensors(t, dtype=None):
    if isinstance(t, dict):
        return {k: tensors(v, dtype) for k, v in t.items()}
    x = torch.from_numpy(np.array(t))
    return x if dtype is None else x.to(dtype)


def leaves(t, prefix=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from leaves(t[k], f"{prefix}/{k}")
    elif t is not None:
        yield prefix, t


def assert_tree_close(got, want, tol, what="", whole_tree=False):
    """Leaf by leaf: max |got - want| <= tol * max |want| (or tol where
    want is 0). ``whole_tree``: the scale is the max |want| of the whole
    tree (for parameters after AdamW, below)."""
    got = dict(leaves(got))
    want = {k: np.asarray(w, np.float32) for k, w in leaves(want)}
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    top = max(float(np.abs(w).max()) for w in want.values() if w.size)
    for name, w in want.items():
        g = got[name]
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        scale = top if whole_tree else (
            float(np.abs(w).max()) if w.size else 0.0)
        bound = tol * scale if scale > 0 else tol
        assert err <= bound, f"{what}{name}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("case", ADAMW_CASES)
def test_adamw_matches_reference(ref, case):
    pre = f"adamw/{case}"
    opt = {"quadratic": AdamWConfig(lr=5e-2, weight_decay=0.0,
                                    warmup_steps=1),
           "clip": AdamWConfig(grad_clip=1.0, warmup_steps=1),
           "bf16_moments": AdamWConfig(moment_dtype="bfloat16"),
           "warmup": AdamWConfig(lr=1.0, warmup_steps=10, weight_decay=0.0),
           "tree": AdamWConfig(warmup_steps=2,
                               moment_dtype="bfloat16")}[case]
    steps = {"quadratic": 300, "clip": 1, "bf16_moments": 3, "warmup": 3,
             "tree": 4}[case]
    params = tensors(tree(ref, f"{pre}/p0"))
    state = adamw_init(params, opt)
    if case == "bf16_moments":
        assert state["m"]["w"].dtype == torch.bfloat16
    target = torch.from_numpy(ref.get(f"{pre}/target",
                                      np.zeros(())))
    for t in range(steps):
        if case == "quadratic":
            g = {"w": 2.0 * (params["w"] - target)}
        else:
            g = tensors(tree(ref, f"{pre}/g{t}"))
        params, state, gnorm = adamw_update(g, state, params, opt)
        k = t + 1
        if k == 300:
            # 300 steps near the minimum amplify f32 rounding (the update
            # is g / sqrt(v) with g -> 0): both runs converge, as the
            # reference's own test asks, and are compared step by step to
            # step 10 above
            for p in (params["w"], torch.from_numpy(ref[f"{pre}/p300/w"])):
                assert float(((p - target) ** 2).sum()) < 1e-2
        elif t in (0, 1, 9, steps - 1):
            assert_tree_close(params, tree(ref, f"{pre}/p{k}"), ADAMW_TOL,
                              f"{case} p{k}")
            assert_tree_close(state["m"], tree(ref, f"{pre}/m{k}"),
                              ADAMW_TOL, f"{case} m{k}")
            assert_tree_close(state["v"], tree(ref, f"{pre}/v{k}"),
                              ADAMW_TOL, f"{case} v{k}")
            np.testing.assert_allclose(float(gnorm), ref[f"{pre}/gnorm{k}"],
                                       rtol=ADAMW_TOL)
    if case == "bf16_moments":
        assert state["m"]["w"].dtype == torch.bfloat16
    assert int(state["step"]) == steps and state["step"].dtype == torch.int32


def test_adamw_donate_updates_in_place_with_the_same_bits():
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn((300, 70), generator=gen),
              "b": torch.randn((5,), generator=gen).to(torch.bfloat16)}
    grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
             for k, v in params.items()}
    opt = AdamWConfig(warmup_steps=1, moment_dtype="bfloat16")
    want_p, want_s, want_g = adamw_update(grads, adamw_init(params, opt),
                                          params, opt)
    state = adamw_init(params, opt)
    held = {k: v.clone() for k, v in params.items()}
    got_p, got_s, got_g = adamw_update(grads, state, held, opt, donate=True)
    assert got_p["a"] is held["a"] and got_s["m"]["b"] is state["m"]["b"]
    for k in params:
        assert torch.equal(got_p[k], want_p[k])
        assert torch.equal(got_s["m"][k], want_s["m"][k])
        assert torch.equal(got_s["v"][k], want_s["v"][k])
    assert torch.equal(got_g, want_g)


def test_compressible_rule_matches_reference(ref):
    got = [compressible(torch.zeros(s), r) for s in
           [(64, 32), (8, 32), (64,), (16, 4), (16, 3), (2, 16, 8)]
           for r in (1, 4)]
    assert got == ref["psa/compressible"].tolist()


@pytest.fixture(scope="module")
def psa_nopod(ref):
    cfg = PSAConfig(rank=4, oi_iters=5, error_feedback=True)
    g = tensors(tree(ref, "psa/g"))
    st = psa_init(g, cfg, proj=tree(ref, "psa/proj"))
    red, ef = compress_grads(g, st, cfg)
    red2, ef2 = compress_grads(g, {"proj": st["proj"], "ef": ef}, cfg)
    return {"st": st, "red": red, "ef": ef, "red2": red2, "ef2": ef2,
            "refresh": psa_refresh(g, st, cfg)["proj"], "g": g}


def test_psa_init_structure_and_own_draws(ref, psa_nopod):
    """Projectors where the reference has them (not ``embed``, not below
    4r rows), one per group of a stacked leaf; the port's own draws are
    orthonormal and the same bits from the same seed."""
    st = psa_nopod["st"]
    assert sorted(k for k, v in st["proj"].items() if v is not None) == \
        sorted(tree(ref, "psa/proj"))
    assert st["proj"]["g"].shape == (3, 32, 4)
    assert st["ef"]["scale"] is None and st["proj"]["embed"] is None
    cfg = PSAConfig(rank=4)
    own = psa_init(psa_nopod["g"], cfg, seed=3)
    again = psa_init(psa_nopod["g"], cfg, seed=3)
    for k, p in own["proj"].items():
        if p is None:
            continue
        assert torch.equal(p, again["proj"][k])
        eye = torch.eye(4).expand(p.shape[:-2] + (4, 4))
        torch.testing.assert_close(p.mT @ p, eye, atol=1e-5, rtol=0)


@pytest.mark.parametrize("what", ["red", "ef", "red2", "ef2", "refresh"])
def test_psa_without_pods_matches_reference(ref, psa_nopod, what):
    assert_tree_close(psa_nopod[what], tree(ref, f"psa/{what}"), PSA_TOL,
                      what)


def test_psa_refresh_stays_orthonormal_where_one_pass_breaks_down(ref):
    """Z = G G^T P with kappa(Z) ~ 1e5: the reference's one CholeskyQR
    pass breaks down (its Cholesky fails: NaN); the port's shifted
    CholeskyQR3 returns an orthonormal basis of the same span as a float64
    QR of the same Z."""
    cfg = PSAConfig(rank=8, oi_iters=1)
    g = {"w": torch.from_numpy(ref["ill/g"])}
    st = psa_init(g, cfg, proj=tree(ref, "ill/proj"))
    q = psa_refresh(g, st, cfg)["proj"]["w"]
    want = ref["ill/new/w"]
    assert not np.isfinite(want).all() or \
        np.abs(want.T @ want - np.eye(8)).max() > 1e-2
    assert bool(torch.isfinite(q).all())
    torch.testing.assert_close(q.mT @ q, torch.eye(8), atol=1e-5, rtol=0)
    # the same f32 Z the refresh forms, then a float64 QR of it
    z = g["w"] @ (st["proj"]["w"].mT @ g["w"]).mT
    q64 = torch.linalg.qr(z.double())[0]
    cos = torch.linalg.svdvals(q64.mT @ q.double())
    assert float(cos.min()) > 1 - 1e-6


def test_psa_refresh_stays_orthonormal_on_the_examples_trajectory(ref):
    """The gradient on which the example's step-32 refresh broke down on
    the card (one pod's ``wk``, one layer): the reference's refresh of it
    is NaN; the port's is finite and orthonormal."""
    traj = np.load(BREAKDOWN)
    cfg = PSAConfig(rank=int(traj["rank"]), oi_iters=int(traj["oi_iters"]))
    assert not np.isfinite(ref["traj/new"]).any()
    g = {"w": torch.from_numpy(traj["g"])}
    st = psa_init(g, cfg, proj={"w": traj["proj"]})
    q = psa_refresh(g, st, cfg)["proj"]["w"]
    assert bool(torch.isfinite(q).all())
    torch.testing.assert_close(q.mT @ q, torch.eye(cfg.rank), atol=1e-5,
                               rtol=0)


def _degenerate(kind):
    gen = torch.Generator().manual_seed(0)
    z = torch.randn((768, 16), generator=gen)
    if kind == "zero_column":
        z[:, 3] = 0.0
    elif kind == "duplicate_column":
        z[:, 5] = z[:, 2]
    elif kind == "rank_4":
        z = z[:, :4] @ torch.randn((4, 16), generator=gen)
    elif kind == "one_group_rank_1":
        z = torch.stack([z, z[:, :1] @ torch.randn((1, 16), generator=gen)])
    else:
        z = torch.zeros((768, 16))
    return z


@pytest.mark.parametrize("kind", ["zero_column", "duplicate_column",
                                  "rank_4", "one_group_rank_1", "zero"])
def test_psa_qr_stays_bounded_on_rank_deficient_input(kind):
    """A Z that is rank-deficient in f32 (a direction the last projector
    lost): every Cholesky pass that breaks down takes a ridge, so the
    projector is finite with singular values <= 1, never NaN."""
    from repro_torch.optim.psa_compress import _cholesky_qr
    q = _cholesky_qr(_degenerate(kind))
    assert bool(torch.isfinite(q).all())
    assert float(torch.linalg.svdvals(q).max()) <= 1.0 + 1e-5


def test_compression_ratio_is_exact(ref):
    import repro_torch.models.transformer as tm
    cfg = reduced_config(get_arch("qwen2-7b"))
    params = tm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    psa = PSAConfig(**PSA_CFG)
    assert compression_ratio(params, psa) == float(ref["lm/ratio"])
    small = {"big": torch.zeros((128, 64)), "small": torch.zeros((4, 4))}
    assert compression_ratio(small, PSAConfig(rank=4)) == \
        (4 * 64 + 16) / (128 * 64 + 16)


def test_loss_and_one_train_step_match_reference(ref):
    cfg = reduced_config(get_arch("qwen2-7b"))
    params = params_from_reference(tree(ref, "lm/params"), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in tree(ref, "lm/batch").items()}
    loss = loss_fn(params, batch, cfg)
    np.testing.assert_allclose(float(loss), ref["lm/loss"], rtol=1e-5)
    opt = AdamWConfig(warmup_steps=1)
    step = make_train_step(cfg, opt, donate=False)
    p1, _, met = step(params, adamw_init(params, opt), batch)
    np.testing.assert_allclose(float(met["loss"]), ref["lm/loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), ref["lm/step_gnorm"],
                               rtol=STEP_TOL)
    assert_tree_close(p1, tree(ref, "lm/step_params"), STEP_TOL, "params ",
                      whole_tree=True)
    # donate=False left the caller's parameters alone
    assert_tree_close(params, tree(ref, "lm/params"), 0.0, "params0 ")


# -- ranks --------------------------------------------------------------
def _rank4(rank, world, dev, ref_path):
    """_ring_gossip and psa_refresh over 4 pods, and over 2 pods of 2."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.psa_compress import _ring_gossip

    ref = dict(np.load(ref_path))
    out = {}
    psa = PSAConfig(**PSA_CFG)
    for pods in (4, 2):
        mesh = make_mesh((("pod", pods), ("data", 4 // pods)), device=dev)
        ax = mesh.axis("pod")
        i = ax.index
        out[f"ring{pods}"] = _ring_gossip(
            torch.from_numpy(ref[f"ring{pods}/z"][i]), ax, 3, pods)
        g = {k: torch.from_numpy(v[i])
             for k, v in tree(ref, f"ring{pods}/g").items()}
        st = psa_init(g, psa, proj=tree(ref, f"ring{pods}/proj"))
        out[f"new{pods}"] = psa_refresh(g, st, psa, pod_axis=ax)["proj"]
        out[f"index{pods}"] = i
    return out


@pytest.fixture(scope="module")
def port4(ref_path):
    # the ranks read the npz themselves: a dict of arrays sent to each
    # spawned process costs seconds
    return spawn_ranks(_rank4, 4, device="cpu", args=(ref_path,))


@pytest.mark.parametrize("pods", [4, 2])
def test_ring_gossip_over_pods_matches_reference(ref, port4, pods):
    for r in port4:
        i = r[f"index{pods}"]
        np.testing.assert_allclose(r[f"ring{pods}"].numpy(),
                                   ref[f"ring{pods}/out"][i], rtol=PSA_TOL,
                                   atol=PSA_TOL)
    if pods == 2:        # one exact averaging round whatever `rounds` is
        z = ref["ring2/z"]
        np.testing.assert_allclose(port4[0]["ring2"].numpy(),
                                   0.5 * z[0] + 0.5 * z[1], rtol=0, atol=0)


@pytest.mark.parametrize("pods", [4, 2])
def test_psa_refresh_over_pods_matches_reference(ref, port4, pods):
    for r in port4:
        i = r[f"index{pods}"]
        want = {k: v[i] for k, v in tree(ref, f"ring{pods}/new").items()}
        assert_tree_close(r[f"new{pods}"], want, PSA_TOL, f"pod {i} ")
        for p in r[f"new{pods}"].values():
            gram = p.mT @ p
            torch.testing.assert_close(
                gram, torch.eye(p.shape[-1]).expand_as(gram), atol=1e-4,
                rtol=0)


def _rank2(rank, world, dev, ref_path, work):
    """A data-parallel train step and the PSA train step (step, refresh,
    step) on this pod's shard, then the driver and the example twin on the
    same two ranks."""
    import argparse

    from repro_torch import train_lm_psa_compress
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import train
    from repro_torch.train.step import make_psa_train_step, shard_batch

    ref = dict(np.load(ref_path))
    cfg = reduced_config(get_arch("qwen2-7b"))
    pod = make_test_mesh(multi_pod=True, device=dev).axis("pod")
    psa = PSAConfig(**PSA_CFG)
    opt = AdamWConfig(warmup_steps=1)
    params = params_from_reference(tree(ref, "lm/params"), device=dev)
    batch = shard_batch({k: torch.from_numpy(v) for k, v in
                         tree(ref, "lm/batch").items()}, pod.index, pod.size)
    psa_state = psa_init(params, psa, proj=tree(ref, "train/proj0"))
    dp_params, _, met = make_train_step(cfg, opt, group=pod, donate=False)(
        params, adamw_init(params, opt), batch)
    out = {"index": pod.index,
           "dp": {"loss": float(met["loss"]),
                  "gnorm": float(met["grad_norm"]),
                  "params": _clone(dp_params)}}
    del dp_params
    step, refresh = make_psa_train_step(cfg, opt, psa, group=pod)
    opt_state = adamw_init(params, opt)
    params, opt_state, psa_state, met = step(params, opt_state, psa_state,
                                             batch)
    out["1"] = {"loss": float(met["loss"]), "gnorm": float(met["grad_norm"]),
                "params": _clone(params), "ef": _clone(psa_state["ef"])}
    psa_state = refresh(params, psa_state, batch)
    out["proj1"] = _clone(psa_state["proj"])
    params, opt_state, psa_state, met = step(params, opt_state, psa_state,
                                             batch)
    out["2"] = {"loss": float(met["loss"]), "gnorm": float(met["grad_norm"]),
                "params": _clone(params), "ef": _clone(psa_state["ef"])}

    def args(steps, ckpt):
        return argparse.Namespace(
            arch="qwen2-7b", reduced=True, mesh="multipod", steps=steps,
            batch=4, seq=8, lr=1e-3, warmup=2, seed=0, data_seed=0,
            psa=True, psa_rank=4, ckpt_dir=ckpt, ckpt_every=2, keep_last=3,
            log_every=100, device="cpu", backend="gloo")

    out["whole"] = train(args(6, os.path.join(work, "whole")))
    out["first"] = train(args(3, os.path.join(work, "split")))
    out["resumed"] = train(args(6, os.path.join(work, "split")))
    out["example"] = train_lm_psa_compress.main(
        ["--device", "cpu", "--steps", "12", "--ckpt-dir",
         os.path.join(work, "example")])
    return out


def _clone(t):
    if isinstance(t, dict):
        return {k: _clone(v) for k, v in t.items()}
    return None if t is None else t.detach().clone()


@pytest.fixture(scope="module")
def port2(ref_path, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("train_runs"))
    return spawn_ranks(_rank2, 2, device="cpu", args=(ref_path, work)), work


def test_data_parallel_train_step_matches_reference(ref, port2):
    """``make_train_step(group=)`` over 2 ranks, each on its half of the
    batch: the gradient and the loss are f32 means over the ranks, so the
    step is the reference's one-rank step on the whole batch."""
    for r in port2[0]:
        got = r["dp"]
        np.testing.assert_allclose(got["loss"], ref["lm/loss"], rtol=1e-5)
        np.testing.assert_allclose(got["gnorm"], ref["lm/step_gnorm"],
                                   rtol=STEP_TOL)
        assert_tree_close(got["params"], tree(ref, "lm/step_params"),
                          STEP_TOL, "params ", whole_tree=True)


@pytest.mark.parametrize("k", ["1", "2"])
def test_psa_train_step_over_two_pods_matches_reference(ref, port2, k):
    """Step 1, then (after a refresh) step 2: the pod-mean loss, the grad
    norm, the parameters and each pod's own error feedback."""
    for r in port2[0]:
        got = r[k]
        np.testing.assert_allclose(got["loss"], ref[f"train/loss{k}"],
                                   rtol=STEP_TOL)
        np.testing.assert_allclose(got["gnorm"], ref[f"train/gnorm{k}"],
                                   rtol=STEP_TOL)
        assert_tree_close(got["params"], tree(ref, f"train/params{k}"),
                          STEP_TOL, f"step {k} params ", whole_tree=True)
        assert_tree_close(got["ef"], tree(ref, f"train/ef{k}",
                                          f"@{r['index']}"),
                          STEP_TOL, f"step {k} pod {r['index']} ef ")


def test_psa_refresh_in_the_train_step_matches_reference(ref, port2):
    """Two pods average exactly: both hold the reference's projectors,
    orthonormal."""
    for r in port2[0]:
        assert_tree_close(r["proj1"], tree(ref, "train/proj1"), STEP_TOL,
                          "proj ")
        for _, p in leaves(r["proj1"]):
            gram = p.mT @ p
            torch.testing.assert_close(
                gram, torch.eye(p.shape[-1]).expand_as(gram), atol=1e-4,
                rtol=0)


def test_train_resumes_bit_for_bit(port2):
    """6 steps equal 3 steps and a resumed 3: the step-6 checkpoint of
    every pod (params, moments, step, projectors, error feedback)."""
    runs, work = port2
    r = runs[0]
    assert r["whole"]["steps_run"] == 6 and r["first"]["steps_run"] == 3
    assert r["resumed"]["steps_run"] == 3
    assert r["resumed"]["last_loss"] == r["whole"]["last_loss"]
    for pod in ("pod0", "pod1"):
        a = np.load(os.path.join(work, "whole", pod, "step_00000006",
                                 "shards.npz"))
        b = np.load(os.path.join(work, "split", pod, "step_00000006",
                                 "shards.npz"))
        assert sorted(a.files) == sorted(b.files) and len(a.files) > 10
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])


def test_example_twin_lowers_the_loss_on_the_cpu(port2):
    out = port2[0][0]["example"]
    assert out["steps_run"] == 12
    assert np.isfinite(out["first_loss"]) and \
        out["last_loss"] < out["first_loss"]
