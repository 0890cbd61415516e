"""The port's roofline CLI (``launch/roofline.main``) against the
reference's modes, in process and on the meta device (no card, no JAX):
the ``long_500k`` skip, ``--mesh-shape``, ``--kv-quant``, ``--split-model``
and ``--all --out``."""
import dataclasses
import json
import os

import pytest
import torch

from repro_torch import _tree
from repro_torch.configs import SHAPES, get_arch, valid_cells
from repro_torch.launch import roofline
from repro_torch.launch.analytic_cost import analytic_cost
from repro_torch.models import transformer as tt


def _cli(capsys, *argv):
    roofline.main(list(argv))
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("aid", ["qwen2-7b", "command-r-35b",
                                 "recurrentgemma-2b"])
def test_long_500k_is_skipped_where_the_reference_skips_it(aid):
    """A full-attention architecture's ``long_500k`` cell is skipped, as
    the reference's ``run_cell`` and ``valid_cells`` skip it; a
    subquadratic one runs, ``"status": "ok"``."""
    res = roofline.run_cell(aid, "long_500k")
    skip = {c["arch"]: c["skip"] for c in valid_cells()
            if c["shape"] == "long_500k"}[aid]
    if skip:
        assert res == {"arch": aid, "shape": "long_500k",
                       "status": "skipped"}
    else:
        assert res["status"] == "ok" and res["roofline"]["bound_s"] > 0


def test_mesh_shape_plans_a_model_axis_of_4(capsys):
    """``--mesh-shape 64,4``: a (data 64, model 4) mesh of 256 ranks, its
    split train step cutting the FLOPs over 4 model ranks; a shape whose
    product is not 256 is refused."""
    res = _cli(capsys, "--arch", "qwen2-7b", "--shape", "train_4k",
               "--mesh-shape", "64,4", "--split-model")
    assert res["mesh"] == {"data": 64, "model": 4}
    assert res["n_devices"] == 256 and res["split_model"]
    plain = roofline.run_cell("qwen2-7b", "train_4k",
                              mesh=roofline.mesh_of("64,4"))
    assert res["flops_per_dev"] * 4 == pytest.approx(plain["flops_per_dev"],
                                                     rel=1e-12)
    assert res["wire_by_axis"]["model"]["all-reduce"] > 0
    with pytest.raises(ValueError, match="256"):
        roofline.mesh_of("16,8")


@pytest.mark.parametrize("aid,shape", [("qwen2-7b", "decode_32k"),
                                       ("recurrentgemma-2b", "long_500k")])
def test_kv_quant_counts_the_int8_cache(capsys, aid, shape):
    """``--kv-quant``: the kv caches' bytes are those
    ``init_decode_state`` allocates for the int8 cache on the meta device
    (1 byte an element of k and v, an f32 scale a (token, kv head)); the
    analytic cost stays the reference's (it ignores the flag), so the
    difference enters the bytes term alone."""
    res = _cli(capsys, "--arch", aid, "--shape", shape, "--kv-quant")
    bf16 = roofline.run_cell(aid, shape)
    cfg = dataclasses.replace(get_arch(aid), kv_quant=True)
    shp = SHAPES[shape]
    state = tt.init_decode_state(cfg, shp.global_batch, shp.seq_len,
                                 device="meta")
    names, leaves, _ = _tree.flatten_with_names(state["caches"])
    kv = sum(x.numel() * x.element_size() for n, x in zip(names, leaves)
             if n.split("/")[-1] in ("k", "v", "k_scale", "v_scale"))
    assert kv == roofline.kv_cache_bytes(cfg, shp)
    assert {x.dtype for n, x in zip(names, leaves)
            if n.split("/")[-1] in ("k", "v")} == {torch.int8}
    assert analytic_cost(cfg, shp) == analytic_cost(get_arch(aid), shp)
    plain_kv = roofline.kv_cache_bytes(get_arch(aid), shp)
    assert res["kv_quant"] and kv < plain_kv
    assert res["cache_bytes"] - bf16["cache_bytes"] == kv - plain_kv
    assert res["bytes_per_dev"] < bf16["bytes_per_dev"]
    if aid == "qwen2-7b":           # attention only: the cache is the kv
        assert res["cache_bytes"] == kv


def test_all_writes_a_file_a_valid_cell(tmp_path, capsys):
    """``--all --out DIR``: one JSON file a ``valid_cells()`` cell, named
    as the reference names them, a skipped cell's too; a second run keeps
    every file, and a file already there is not rewritten."""
    out = str(tmp_path / "roof")
    os.makedirs(out)
    kept = os.path.join(out, "qwen2-7b__train_4k.json")
    with open(kept, "w") as f:
        f.write("{}")
    assert _cli(capsys, "--all", "--out", out) == {
        "written": len(valid_cells()) - 1, "kept": 1}
    files = sorted(os.listdir(out))
    assert files == sorted(f"{c['arch']}__{c['shape']}.json"
                           for c in valid_cells())
    with open(kept) as f:
        assert f.read() == "{}"
    for c in valid_cells():
        with open(os.path.join(out, f"{c['arch']}__{c['shape']}.json")) as f:
            res = json.load(f)
        if (c["arch"], c["shape"]) != ("qwen2-7b", "train_4k"):
            assert res["status"] == ("skipped" if c["skip"] else "ok")
    assert _cli(capsys, "--all", "--out", out) == {
        "written": 0, "kept": len(valid_cells())}
