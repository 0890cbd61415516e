"""The compute split over "model" (tensor parallelism) over gloo ranks
(CPU), against one process, the unsplit route and the reference.

One spawn of 4 gloo ranks lays a (2, 2) ("data", "model") mesh out. Each
rank holds its blocks of the parameters (``models/sharding.shard_tree`` by
``param_specs``) and, for reduced h2o-danube-1.8b (sliding window),
qwen2-7b (qkv bias, GQA) and phi3.5-moe (experts over "model", capacity
MOE_CF so that routing drops pairs), runs
``make_sharded_value_and_grad(split_model=True)`` at each remat, the
unsplit route (``split_model=False``), one split AdamW step, and
``make_sharded_serve_step``'s prefill and DECODE_STEPS decode steps.

Held: the loss against one process's ``loss_fn`` on the global batch (its
MoE routed per data shard, ``act_specs["moe"]["n_dp"]`` = 2, as the split
step's ranks route their shards) and against the reference's; the
gradients, gathered back, against one process and the unsplit route;
the three remats' gradients bit for bit; the norms' gradients and the MoE
routes equal on the model ranks of a data shard; the prefill's and
decode's logits against one process's ``forward`` / ``decode_step``; the
wire bytes a rank counted equal to ``roofline.step_wire_bytes`` exactly,
and the model axis's all-reduces: as many under ``"names"`` as under
``False``, more under ``True``. The families and meshes the split does not
cover raise.

The ranks start by ``spawn`` and import this module: it imports no JAX at
module level. Tolerances: F32_TOL relative (f32 sums in another order:
partial products summed over ranks); the gradients within F32_TOL of their
leaf's largest; the logits within SERVE_TOL of their largest. The AdamW
step is held to AdamW of the split gradient bit for bit, not to the other
route's step: a first step moves an element by ~lr times the sign of its
gradient, so elements whose gradient is ~0 flip with the summation order.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch import configs as tcfg
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import roofline
from repro_torch.launch.mesh import Mesh, spawn_ranks
from repro_torch.models import moe
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tt
from repro_torch.optim.adamw import AdamWConfig

F32_TOL = 2e-5
SERVE_TOL = 1e-5
SPLIT = ("h2o-danube-1.8b", "qwen2-7b", "phi3.5-moe-42b-a6.6b")
UNSPLIT = ("recurrentgemma-2b", "xlstm-1.3b", "paligemma-3b",
           "musicgen-medium")
REMATS = (False, True, "names")
MESH = (("data", 2), ("model", 2))
SB, SS, DECODE_STEPS = 4, 16, 4
MOE_CF = 0.5
N_DP = {"moe": {"n_dp": 2}}     # one process routing as the data shards do


def _cfg(configs, aid):
    cfg = configs.reduced_config(configs.get_arch(aid))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_CF))
    return cfg


def _counters(mesh):
    return {a: (dict(g.wire_bytes), dict(g.calls))
            for a, g in mesh.groups.items()}


def _since(mesh, before):
    return {a: ({k: g.wire_bytes[k] - before[a][0][k] for k in g.wire_bytes},
                {k: g.calls[k] - before[a][1][k] for k in g.calls})
            for a, g in mesh.groups.items()}


def _rank(rank, world, dev, work):
    """Each SPLIT model on the (2, 2) mesh (module docstring)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.train.step import (make_sharded_serve_step,
                                        make_sharded_train_step,
                                        make_sharded_value_and_grad)
    mesh = make_mesh(MESH, device=dev)
    shape = shd.MeshShape.from_mesh(mesh)
    out = {"coords": mesh.coords}
    inner = moe.route
    routes = []

    def recording(xf, router, m, cap):
        plan = inner(xf, router, m, cap)
        routes.append([t.clone() for t in plan])
        return plan

    moe.route = recording
    for aid in SPLIT:
        cfg = _cfg(tcfg, aid)
        full = torch.load(os.path.join(work, f"{aid}.pt"))
        batch = torch.load(os.path.join(work, f"{aid}_batch.pt"))
        pspecs = shd.param_specs(full, cfg, shape)
        params = shd.shard_tree(full, pspecs, shape, mesh.coords)
        local = shd.shard_tree(batch, shd.batch_specs(cfg, shape, SB), shape,
                               mesh.coords)
        res = {"remat": {}}
        for remat in REMATS:
            vg = make_sharded_value_and_grad(cfg, mesh, global_batch=SB,
                                             remat=remat, split_model=True)
            routes.clear()
            before = _counters(mesh)
            loss, grads, gnorm = vg(params, local)
            wire = _since(mesh, before)
            res["remat"][remat] = {
                "loss": float(loss), "grad_norm": float(gnorm),
                "wire": wire, "routes": list(routes),
                "norms": {n: g for n, g in zip(
                    *_tree.flatten_with_names(grads)[:2])
                    if n.split("/")[-1] in ("norm1", "norm2", "final_norm")},
                "grads": shd.gather_tree(grads, pspecs, mesh)}
        vg = make_sharded_value_and_grad(cfg, mesh, global_batch=SB,
                                         split_model=False)
        loss, grads, gnorm = vg(params, local)
        res["plain"] = {"loss": float(loss), "grad_norm": float(gnorm),
                        "grads": shd.gather_tree(grads, pspecs, mesh)}
        opt = AdamWConfig(warmup_steps=1)
        step = make_sharded_train_step(cfg, opt, mesh, global_batch=SB,
                                       split_model=True)
        p = tt.tree_map(lambda x: x.clone(), params)
        p, _, met = step(p, adamw_init(p, opt), local)
        loss, grads, gnorm = make_sharded_value_and_grad(
            cfg, mesh, global_batch=SB, split_model=True)(params, local)
        q = tt.tree_map(lambda x: x.clone(), params)
        q, _, _ = adamw_update(grads, adamw_init(q, opt), q, opt,
                               donate=True, gnorm=gnorm)
        res["step"] = {"loss": float(met["loss"]),
                       "grad_norm": float(met["grad_norm"]),
                       "equal": all(torch.equal(a, b) for a, b in zip(
                           _tree.tree_leaves(p), _tree.tree_leaves(q)))}
        prefill, decode = make_sharded_serve_step(cfg, mesh, SB)
        before = _counters(mesh)
        res["prefill"] = prefill(params, {"tokens": local["tokens"]})
        res["prefill_wire"] = _since(mesh, before)
        state = tt.init_decode_state(cfg, SB // 2, SS, device=dev,
                                     model=mesh.axis("model"))
        res["decode"], res["decode_wire"] = [], []
        for t in range(DECODE_STEPS):
            before = _counters(mesh)
            logits, state = decode(params, state,
                                   local["tokens"][:, t:t + 1])
            res["decode_wire"].append(_since(mesh, before))
            res["decode"].append(logits)
        out[aid] = res
    moe.route = inner
    return out


def _assemble(ranks, key):
    """The global (b, s, V) logits from each rank's (b / 2, s, V / 2)."""
    rows = {}
    for r in ranks:
        rows.setdefault(r["coords"]["data"], {})[r["coords"]["model"]] = \
            key(r)
    return torch.cat([torch.cat([rows[d][m] for m in sorted(rows[d])], -1)
                      for d in sorted(rows)], 0)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The ranks' results, and one process's and the reference's on the
    same parameters and batches."""
    import jax
    from repro import configs as jcfg
    from repro.train.step import loss_fn as jloss_fn
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.train.step import _value_and_grad
    work = str(tmp_path_factory.mktemp("tp"))
    one = {}
    for aid in SPLIT:
        tc, jc = _cfg(tcfg, aid), _cfg(jcfg, aid)
        params = tt.init_params(torch.Generator().manual_seed(0), tc,
                                device="cpu")
        batch = make_lm_batch(tc, 0, 0, SB, SS, device="cpu")
        torch.save(params, os.path.join(work, f"{aid}.pt"))
        torch.save(batch, os.path.join(work, f"{aid}_batch.pt"))
        aspecs = {"act": None, "logits": None, "attn_q": None,
                  "attn_kv": None,
                  "moe": {"dp": None, "e": None, "n_dp": 2}}
        ref_loss = float(jax.jit(lambda p, b: jloss_fn(
            p, b, jc, remat=False, act_specs=aspecs))(
            tt.tree_map(lambda t: t.numpy(), params),
            {k: v.numpy() for k, v in batch.items()}))
        loss, grads = _value_and_grad(params, batch, tc, act_specs=N_DP)
        with torch.inference_mode():
            logits = tt.forward(params, {"tokens": batch["tokens"]}, tc,
                                act_specs=N_DP)
            state = tt.init_decode_state(tc, SB, SS, device="cpu")
            steps = []
            for t in range(DECODE_STEPS):
                lg, state = tt.decode_step(
                    params, state, batch["tokens"][:, t:t + 1], tc,
                    act_specs=N_DP)
                steps.append(lg)
        one[aid] = {"cfg": tc, "ref_loss": ref_loss, "loss": float(loss),
                    "grads": grads, "prefill": logits, "decode": steps}
    ranks = spawn_ranks(_rank, 4, backend="gloo", device="cpu",
                        args=(work,))
    return ranks, one


def _leaf_errs(got, want):
    """Per leaf: max |got - want| / max |want|."""
    names, w, _ = _tree.flatten_with_names(want)
    return {n: float((g - x).abs().max()) / max(float(x.abs().max()), 1e-30)
            for n, g, x in zip(names, _tree.tree_leaves(got), w)}


@pytest.mark.parametrize("aid", SPLIT)
def test_split_loss_matches_one_process_and_reference(split, aid):
    ranks, one = split
    o = one[aid]
    np.testing.assert_allclose(o["loss"], o["ref_loss"], rtol=F32_TOL)
    for r in ranks:
        for remat in REMATS:
            got = r[aid]["remat"][remat]["loss"]
            np.testing.assert_allclose(got, o["loss"], rtol=F32_TOL)
            np.testing.assert_allclose(got, o["ref_loss"], rtol=F32_TOL)
            assert got == r[aid]["remat"][False]["loss"]
        np.testing.assert_allclose(r[aid]["plain"]["loss"], o["loss"],
                                   rtol=F32_TOL)
        assert r[aid]["remat"][True]["loss"] == ranks[0][aid]["remat"][
            True]["loss"]


@pytest.mark.parametrize("aid", SPLIT)
def test_split_gradients_match_one_process_and_the_plain_route(split, aid):
    """Every leaf gathered back within F32_TOL of its largest, against one
    process and the unsplit route; the three remats bit for bit; the grad
    norm counting each element once."""
    ranks, one = split
    o = one[aid]
    want_norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in
                                     _tree.tree_leaves(o["grads"]))))
    for r in ranks:
        res = r[aid]
        got = res["remat"][True]["grads"]
        for want in (o["grads"], res["plain"]["grads"]):
            errs = _leaf_errs(got, want)
            assert max(errs.values()) <= F32_TOL, sorted(
                errs.items(), key=lambda kv: -kv[1])[:3]
        for remat in ("names", False):
            assert all(torch.equal(a, b) for a, b in zip(
                _tree.tree_leaves(res["remat"][remat]["grads"]),
                _tree.tree_leaves(got)))
        np.testing.assert_allclose(res["remat"][True]["grad_norm"],
                                   want_norm, rtol=F32_TOL)
        np.testing.assert_allclose(res["plain"]["grad_norm"], want_norm,
                                   rtol=F32_TOL)


@pytest.mark.parametrize("aid", SPLIT)
def test_split_train_step_is_adamw_of_the_split_gradient(split, aid):
    """``make_sharded_train_step(split_model=True)``: its update is AdamW
    of the split gradient, clipped by its norm, bit for bit; its loss and
    norm those of the split gradient (the norm within F32_TOL of the
    unsplit route's)."""
    ranks, _ = split
    for r in ranks:
        got = r[aid]["step"]
        assert got["equal"]
        assert got["loss"] == r[aid]["remat"][True]["loss"]
        assert got["grad_norm"] == r[aid]["remat"][True]["grad_norm"]
        np.testing.assert_allclose(got["grad_norm"],
                                   r[aid]["plain"]["grad_norm"],
                                   rtol=F32_TOL)


@pytest.mark.parametrize("aid", SPLIT)
def test_norm_gradients_and_moe_routes_equal_across_model_ranks(split,
                                                                 aid):
    """The replicated norms' gradients, and every MoE route (and its
    recomputation under remat), equal on the model ranks of a data
    shard."""
    ranks, one = split
    by_data = {}
    for r in ranks:
        by_data.setdefault(r["coords"]["data"], []).append(r[aid])
    for pair in by_data.values():
        for remat in REMATS:
            a, b = (p["remat"][remat] for p in pair)
            assert a["norms"] and a["norms"].keys() == b["norms"].keys()
            assert all(torch.equal(a["norms"][n], b["norms"][n])
                       for n in a["norms"])
            assert len(a["routes"]) == len(b["routes"])
            for ra, rb in zip(a["routes"], b["routes"]):
                assert all(torch.equal(x, y) for x, y in zip(ra, rb))
    if one[aid]["cfg"].moe is None:
        return
    res = ranks[0][aid]["remat"]
    n = len(res[False]["routes"])
    assert n == one[aid]["cfg"].n_layers
    # remat=True routes each layer again in the recomputation: the same
    assert len(res[True]["routes"]) == 2 * n
    for first, again in zip(res[True]["routes"][:n], res[True]["routes"][n:]):
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("aid", SPLIT)
def test_serve_prefill_and_decode_match_one_process(split, aid):
    ranks, one = split
    o = one[aid]
    got = _assemble(ranks, lambda r: r[aid]["prefill"])
    want = o["prefill"]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= SERVE_TOL * float(
        want.abs().max())
    for t in range(DECODE_STEPS):
        got = _assemble(ranks, lambda r: r[aid]["decode"][t])
        want = o["decode"][t]
        assert float((got - want).abs().max()) <= SERVE_TOL * float(
            want.abs().max())


@pytest.mark.parametrize("aid", SPLIT)
def test_split_wire_bytes_equal_step_wire_bytes(split, aid):
    """Each rank's counted bytes equal the plan exactly, at each remat;
    the model axis runs as many all-reduces under "names" as under False,
    and more under True (the forward's again)."""
    ranks, one = split
    cfg = one[aid]["cfg"]
    mesh = shd.MeshShape.of(*MESH)
    shape = ShapeConfig("tp", SS, SB, "train")
    for r in ranks:
        calls = {}
        for remat in REMATS:
            want = roofline.step_wire_bytes(cfg, shape, mesh,
                                            split_model=True, remat=remat)
            wire = r[aid]["remat"][remat]["wire"]
            for a in want:
                for kind in want[a]:
                    assert wire[a][0][kind] == want[a][kind], (remat, a, kind)
                assert wire[a][0]["collective-permute"] == 0.0
            calls[remat] = wire["model"][1]["all-reduce"]
        assert calls["names"] == calls[False] < calls[True]
    blocks = cfg.n_layers
    plain = roofline.step_wire_bytes(cfg, shape, mesh)
    split_ = roofline.step_wire_bytes(cfg, shape, mesh, split_model=True)
    assert split_["data"]["all-gather"] < plain["data"]["all-gather"]
    assert calls[True] - calls[False] == 2 * blocks


@pytest.mark.parametrize("aid", SPLIT)
def test_serve_wire_bytes_equal_step_wire_bytes(split, aid):
    """The prefill's and each decode step's counted bytes (the data-axis
    gathers of the blocks, the embedding's gather and the forward's
    reduces over "model") equal the plan exactly."""
    ranks, one = split
    cfg = one[aid]["cfg"]
    mesh = shd.MeshShape.of(*MESH)
    plans = {kind: roofline.step_wire_bytes(
        cfg, ShapeConfig(kind, SS, SB, kind), mesh, split_model=True)
        for kind in ("prefill", "decode")}
    assert plans["prefill"]["model"]["all-reduce"] > 0
    for r in ranks:
        for kind, wires in (("prefill", [r[aid]["prefill_wire"]]),
                            ("decode", r[aid]["decode_wire"])):
            for wire in wires:
                for a, want in plans[kind].items():
                    for k in want:
                        assert wire[a][0][k] == want[k], (kind, a, k)


@pytest.mark.parametrize("aid", SPLIT)
def test_model_view_blocks_are_the_sharded_leaves(aid):
    """The view's head, kv head, FFN, expert and vocabulary blocks are
    the rank's blocks of the leaves after the data-axis gather."""
    cfg = _cfg(tcfg, aid)
    mesh = shd.MeshShape.of(*MESH)
    params = tt.init_params(None, cfg, device="meta")
    specs = shd.param_specs(params, cfg, mesh)
    dspecs = shd.data_specs(specs, mesh)
    blk = f"blk0_{cfg.pattern_for_layers()[0]}"

    def model_block(*path):
        """A leaf's shape after the data-axis gather: cut by "model"."""
        leaf, spec = params, specs
        for k in path:
            leaf, spec = leaf[k], spec[k]
        return shd.local_shape(leaf.shape, tuple(
            "model" if shd.has_model((e,)) else None for e in spec), mesh)

    mixer, ffn = ("groups", blk, "mixer"), ("groups", blk, "ffn")
    for m in range(2):
        view = shd.model_view(cfg, mesh, m)
        assert view.tp == 2 and view.embed_pieces == 2
        width = lambda r: r[1] - r[0]
        assert view.heads == (m * cfg.n_heads // 2,
                              (m + 1) * cfg.n_heads // 2)
        assert model_block(*mixer, "wq")[-1] == width(view.heads) * cfg.hd
        assert model_block(*mixer, "wk")[-1] == width(view.kv_heads) * cfg.hd
        assert model_block(*mixer, "wo")[1] == width(view.heads) * cfg.hd
        assert view.vocab == (m * cfg.vocab_size // 2,
                              (m + 1) * cfg.vocab_size // 2)
        assert model_block("lm_head")[-1] == width(view.vocab)
        if cfg.moe is None:
            assert model_block(*ffn, "w_up")[-1] == width(view.ffn_cols)
            assert view.experts is None
        else:
            assert view.experts == (m * cfg.moe.n_experts // 2,
                                    (m + 1) * cfg.moe.n_experts // 2)
            assert model_block(*ffn, "w_up")[1] == width(view.experts)
    assert dspecs["embed"] == (None, "data")
    assert dspecs["lm_head"] == ("data", None)


def _fake_mesh(sizes):
    names = tuple(a for a, _ in sizes)
    return Mesh(names, dict(sizes), dict.fromkeys(names, 0), {},
                torch.device("cpu"), "gloo")


@pytest.mark.parametrize("aid", UNSPLIT)
def test_split_refused_for_the_unsplit_families(aid):
    """The four families the split does not cover raise when it is asked
    for, naming the ROADMAP item; none takes another route."""
    from repro_torch.train.step import (make_sharded_serve_step,
                                        make_sharded_train_step)
    cfg = tcfg.reduced_config(tcfg.get_arch(aid))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        shd.model_view(cfg, shd.MeshShape.of(*MESH))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_sharded_train_step(cfg, AdamWConfig(), _fake_mesh(MESH),
                                global_batch=SB, split_model=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_sharded_serve_step(cfg, _fake_mesh(MESH), SB)


@pytest.mark.parametrize("case", ["kv_heads", "tied", "batch"])
def test_split_refused_where_it_does_not_divide(case):
    """kv heads that do not divide over "model" (2 over 4), a tied head,
    and a serving batch that does not divide over "data" raise."""
    from repro_torch.train.step import (make_sharded_serve_step,
                                        make_sharded_train_step)
    cfg = _cfg(tcfg, "qwen2-7b")
    sizes = MESH
    if case == "kv_heads":
        sizes = (("data", 1), ("model", 4))
    elif case == "tied":
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if case == "batch":
            make_sharded_serve_step(cfg, _fake_mesh(sizes), SB + 1)
        else:
            make_sharded_train_step(cfg, AdamWConfig(), _fake_mesh(sizes),
                                    global_batch=SB, split_model=True)
