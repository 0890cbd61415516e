"""The port's sharding rules, dry-run plan, roofline, wire counter and
sharded train step against the reference's (CPU).

Specs: the reference's rules run over ``jax.sharding.AbstractMesh`` (no
devices) on ``jax.eval_shape`` trees, the port's over ``MeshShape`` on
meta-device trees, for all ten architectures on the production meshes
(16, 16) and (2, 16, 16). A ``PartitionSpec`` is compared as the tuple of
its entries. Per-rank bytes: the reference's specs applied to its abstract
state against ``launch/dryrun.memory_plan`` (exact integers).

The sharded train step over gloo ranks: test_torch_sharded_step.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro import configs as jcfg
from repro.launch.hlo_analysis import roofline_terms as jroofline_terms
from repro.launch.mesh import HW as TPU_HW
from repro.models import sharding as jshd
from repro.models import transformer as jt
from repro.optim.psa_compress import psa_init as jpsa_init
from repro_torch import configs as tcfg
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tt

MESHES = {"sp": ((16, 16), ("data", "model")),
          "mp": ((2, 16, 16), ("pod", "data", "model"))}


def _tuple(spec):
    """A reference ``PartitionSpec`` (or None) as the port's tuple."""
    return None if spec is None else tuple(spec)


def _ref_specs(tree):
    return [_tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


@pytest.fixture(scope="module")
def abstract():
    """aid -> the reference's eval_shape'd params and the port's meta
    params, full size."""
    cache = {}

    def get(aid):
        if aid not in cache:
            jc, tc = jcfg.get_arch(aid), tcfg.get_arch(aid)
            cache[aid] = dict(jc=jc, tc=tc, jp=jax.eval_shape(
                lambda k: jt.init_params(k, jc),
                jax.ShapeDtypeStruct((2,), jnp.uint32)),
                tp=tt.init_params(None, tc, device="meta"))
        return cache[aid]
    return get


def _meshes(key):
    sizes, names = MESHES[key]
    return (AbstractMesh(sizes, names),
            shd.MeshShape(names, sizes))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("aid", jcfg.ARCH_IDS)
def test_specs_match_reference(aid, mesh, abstract):
    """param_specs leaf by leaf, batch_specs, constraint_spec and
    activation_specs at every shape's batch, decode_state_specs of every
    prefill and decode cell's cache."""
    a = abstract(aid)
    jm, tm = _meshes(mesh)
    want = _ref_specs(jshd.param_specs(a["jp"], a["jc"], jm))
    got = shd.spec_leaves(shd.param_specs(a["tp"], a["tc"], tm))
    assert got == want
    for shape in jcfg.SHAPES.values():
        b = shape.global_batch
        assert shd.batch_specs(a["tc"], tm, b) == {
            k: _tuple(v) for k, v in jshd.batch_specs(a["jc"], jm, b).items()}
        assert shd.constraint_spec(a["tc"], tm, b) == _tuple(
            jshd.constraint_spec(a["jc"], jm, b))
        for seq in (None, shape.seq_len):
            ja = jshd.activation_specs(a["jc"], jm, b, seq)
            assert shd.activation_specs(a["tc"], tm, b, seq) == {
                k: (v if k == "moe" else _tuple(v)) for k, v in ja.items()}
    for cell in jcfg.valid_cells():
        shape = jcfg.SHAPES[cell["shape"]]
        if cell["arch"] != aid or cell["skip"] or shape.kind == "train":
            continue
        b, s = shape.global_batch, shape.seq_len
        jst = jax.eval_shape(lambda: jt.init_decode_state(a["jc"], b, s))
        tst = tt.init_decode_state(a["tc"], b, s, device="meta")
        want = _ref_specs(jshd.decode_state_specs(jst, a["jc"], jm, b))
        got = shd.spec_leaves(shd.decode_state_specs(tst, a["tc"], tm, b))
        assert got == want, cell


def test_kimi_moe_activation_spec_on_the_multipod_mesh():
    got = shd.activation_specs(tcfg.get_arch("kimi-k2-1t-a32b"),
                               make_production_mesh(multi_pod=True), 256)
    assert got["moe"] == {"dp": ("pod", "data"), "e": "model", "n_dp": 32}


def _ref_rank_bytes(tree, specs, mesh_shape):
    total = 0
    sizes = dict(zip(mesh_shape.axis_names, mesh_shape.sizes))
    leaves = jax.tree.leaves(tree)
    for leaf, spec in zip(leaves, _ref_specs(specs)):
        n = 1
        for dim, entry in zip(leaf.shape, spec + (None,) * (
                len(leaf.shape) - len(spec))):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= dim // int(np.prod([sizes[x] for x in axes]))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("aid", jcfg.ARCH_IDS)
def test_dryrun_plan_matches_reference_specs(aid, mesh, abstract):
    """Each part of every cell's per-rank plan equals the bytes the
    reference's specs give its abstract state (PSA replicated, on the
    multi-pod train cell)."""
    a = abstract(aid)
    jm, tm = _meshes(mesh)
    pspecs = jshd.param_specs(a["jp"], a["jc"], jm)
    params = _ref_rank_bytes(a["jp"], pspecs, tm)
    mdt = dryrun._moment_dtype(a["tc"])
    for cell in jcfg.valid_cells():
        if cell["arch"] != aid or cell["skip"]:
            continue
        res = dryrun.run_cell(aid, cell["shape"], multi_pod=mesh == "mp",
                              psa=mesh == "mp")
        plan, shape = res["per_rank"], jcfg.SHAPES[cell["shape"]]
        assert plan["params"]["bytes"] == params, cell
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            numels = [n // np.dtype(leaf.dtype).itemsize for n, leaf in zip(
                _per_leaf(a["jp"], pspecs, tm), jax.tree.leaves(a["jp"]))]
            assert plan["opt"]["bytes"] == \
                2 * sum(numels) * np.dtype(mdt).itemsize + 4, cell
            if mesh == "mp":
                jpsa = jax.eval_shape(lambda p: jpsa_init(
                    p, tcfg.get_psa_config()), a["jp"])
                assert plan["psa"]["bytes"] == sum(
                    int(np.prod(x.shape)) * 4 for x in jax.tree.leaves(jpsa))
            else:
                assert "psa" not in plan
        else:
            jst = jax.eval_shape(lambda: jt.init_decode_state(a["jc"], b, s))
            dspecs = jshd.decode_state_specs(jst, a["jc"], jm, b)
            assert plan["decode_state"]["bytes"] == _ref_rank_bytes(
                {"caches": jst["caches"]},
                {"caches": dspecs["caches"]}, tm), cell
        bspecs = jshd.batch_specs(a["jc"], jm, b)
        tok = (b, 1 if shape.kind == "decode" else s) + (
            (a["jc"].n_codebooks,) if a["jc"].frontend == "audio_codec"
            else ())
        ins = {"tokens": jax.ShapeDtypeStruct(tok, jnp.int32)}
        if shape.kind == "train":
            ins["labels"] = ins["tokens"]
        if shape.kind != "decode" and a["jc"].frontend == "vlm_patches":
            ins["patch_embeds"] = jax.ShapeDtypeStruct(
                (b, a["jc"].n_prefix_tokens, a["jc"].d_model), jnp.float32)
        assert plan["inputs"]["bytes"] == _ref_rank_bytes(
            ins, {k: bspecs[k] for k in ins}, tm), cell
        assert plan["total"]["alloc"] >= plan["total"]["bytes"]
        assert res["fits"] == (plan["total"]["alloc"] <= roofline.HW.HBM_BYTES)


def _per_leaf(tree, specs, mesh_shape):
    return [_ref_rank_bytes(leaf, spec, mesh_shape) for leaf, spec in zip(
        jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, P)))]


def test_dryrun_all_reports_every_cell():
    results = dryrun.run_all()
    assert len(results) == 2 * len(jcfg.valid_cells())
    for res in results:
        assert res["status"] in ("ok", "skipped")
        if res["status"] == "ok":
            assert res["per_rank"]["params"]["bytes"] > 0
            assert res["roofline"]["bound_s"] > 0


def test_model_flops_and_roofline_terms_match_reference():
    """tests/test_system.py's model_flops formula and roofline dominance,
    and the reference's roofline_terms on the same hardware numbers."""
    cfg = tcfg.get_arch("qwen2-7b")
    n = cfg.param_count()
    shapes = tcfg.SHAPES
    assert roofline.model_flops(cfg, shapes["train_4k"]) == \
        6.0 * n * 4096 * 256
    assert roofline.model_flops(cfg, shapes["decode_32k"]) == 2.0 * n * 128
    moe = tcfg.get_arch("kimi-k2-1t-a32b")
    assert roofline.model_flops(moe, shapes["train_4k"]) == \
        6.0 * moe.active_param_count() * 4096 * 256
    assert dryrun.model_flops is roofline.model_flops

    class Both(TPU_HW):
        LINK_BW = TPU_HW.ICI_LINK_BW
    for args in (dict(flops_per_dev=197e12, bytes_per_dev=819e7,
                      wire_bytes_per_dev=50e7),
                 dict(flops_per_dev=1, bytes_per_dev=819e9,
                      wire_bytes_per_dev=1),
                 dict(flops_per_dev=1, bytes_per_dev=1,
                      wire_bytes_per_dev=3e11)):
        assert roofline.roofline_terms(**args, hw=Both) == \
            jroofline_terms(**args, hw=Both)
    hw = roofline.HW
    t = roofline.roofline_terms(flops_per_dev=hw.PEAK_FLOPS_BF16,
                                bytes_per_dev=hw.HBM_BW / 100,
                                wire_bytes_per_dev=hw.LINK_BW / 100)
    assert t["dominant"] == "compute" and t["t_compute_s"] == 1.0
    t2 = roofline.roofline_terms(flops_per_dev=1, bytes_per_dev=hw.HBM_BW,
                                 wire_bytes_per_dev=1)
    assert t2["dominant"] == "memory"


def test_roofline_cell_on_one_card_is_the_analytic_cost():
    from repro_torch.launch.analytic_cost import analytic_cost
    cfg = tcfg.get_arch("qwen2-7b")
    shape = ShapeConfig("p", 2048, 4, "prefill")
    res = roofline.run_cell("qwen2-7b", shape, mesh=shd.MeshShape.of(
        ("data", 1), ("model", 1)), measured_s=0.25)
    cost = analytic_cost(cfg, shape)
    assert res["flops_per_dev"] == cost["flops"]
    assert res["bytes_per_dev"] == cost["hbm_bytes"]
    assert res["wire_bytes_per_dev"] == 0.0
    assert res["roofline"]["dominant"] == "compute"
    assert res["bound_share_of_measured"] == res["roofline"]["bound_s"] / 0.25


def test_elastic_restore_recuts_a_4x2_save_onto_2x4(tmp_path):
    """tests/test_spmd.py's elastic case: a tree saved from a (4, 2) mesh
    restored onto (2, 4), every rank's block, and the blocks put back
    together equal the tree."""
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    specs = {"w": ("data", "model")}
    m1 = shd.MeshShape.of(("data", 4), ("model", 2))
    m2 = shd.MeshShape.of(("data", 2), ("model", 4))
    blocks = [shd.shard_tree({"w": w}, specs, m1, m1.coords(r))["w"]
              for r in range(m1.size)]
    assert blocks[3].shape == (2, 4)
    mgr = CheckpointManager(str(tmp_path))
    whole = torch.cat([torch.cat(blocks[2 * i:2 * i + 2], 1)
                       for i in range(4)])
    mgr.save(1, {"w": whole})
    out = torch.empty(8, 8)
    for r in range(m2.size):
        got, step = mgr.restore({"w": w}, mesh=(m2, m2.coords(r)),
                                specs=specs)
        c = m2.coords(r)
        assert step == 1 and got["w"].shape == (4, 2)
        out[4 * c["data"]:4 * c["data"] + 4,
            2 * c["model"]:2 * c["model"] + 2] = got["w"]
    assert torch.equal(out, w)
