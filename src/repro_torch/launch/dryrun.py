"""Per-rank memory plan of every (arch x shape x mesh) cell, on the meta
device: the twin of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell for 512 placeholder TPU devices
and reads XLA's memory and cost analyses. What has a torch meaning is the
plan that comes before: the parameters (``init_params``), AdamW's state
(``adamw_init``), the PSA state (``psa_init``), the decode state
(``init_decode_state``) and the inputs, built on ``torch.device("meta")``
(shapes and dtypes, no storage), each leaf cut by the reference's sharding
rules (``models/sharding.py``) over the production mesh shape. A rank's
bytes are the sum of its blocks' bytes. ``alloc`` rounds each block up to
512 bytes, as the CUDA caching allocator does with expandable segments
(every block split to that size): what ``torch.cuda.memory_allocated``
reads for a rank that holds exactly these tensors. Projectors and error
buffers of PSA are replicated (the reference gives them ``P()``).

Each cell also gets its roofline terms on the H100 and the wire bytes the
port's step would send (``launch/roofline.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --multipod
  python -m repro_torch.launch.dryrun --all [--out DIR] [--no-remat]
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import _tree
from ..configs import SHAPES, get_arch, get_psa_config, valid_cells
from ..configs.base import ModelConfig, PSAConfig, ShapeConfig
from ..models import sharding as shd
from ..models.transformer import init_decode_state, init_params
from ..optim.adamw import AdamWConfig, adamw_init
from ..optim.psa_compress import psa_init
from .mesh import make_production_mesh
from .roofline import HW, model_flops
from .roofline import run_cell as roofline_cell

__all__ = ["input_specs", "abstract_state", "model_flops", "memory_plan",
           "run_cell", "ALLOC_GRANULE"]

META = torch.device("meta")
ALLOC_GRANULE = 512     # the CUDA caching allocator's block size unit


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(inputs, specs): meta stand-ins for every model input of this cell
    and their specs (``batch_specs``)."""
    b, s = shape.global_batch, shape.seq_len
    bspecs = shd.batch_specs(cfg, mesh, b)
    s = 1 if shape.kind == "decode" else s
    tshape = (b, s, cfg.n_codebooks) if cfg.frontend == "audio_codec" \
        else (b, s)
    out = {"tokens": torch.empty(tshape, dtype=torch.int32, device=META)}
    if shape.kind == "train":
        out["labels"] = torch.empty(tshape, dtype=torch.int32, device=META)
    if shape.kind != "decode" and cfg.frontend == "vlm_patches":
        out["patch_embeds"] = torch.empty(
            (b, cfg.n_prefix_tokens, cfg.d_model), dtype=torch.float32,
            device=META)
    return out, {k: bspecs[k] for k in out}


@functools.lru_cache(maxsize=None)
def _meta_params(cfg: ModelConfig):
    return init_params(None, cfg, device=META)


def abstract_state(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   opt: AdamWConfig, *, psa: Optional[PSAConfig] = None
                   ) -> Dict[str, Any]:
    """Meta-device params, optimizer, PSA and decode state of a cell, each
    with its spec tree (``*_specs``)."""
    params = _meta_params(cfg)
    pspecs = shd.param_specs(params, cfg, mesh)
    out = {"params": params, "params_specs": pspecs}
    if shape.kind == "train":
        out["opt"] = adamw_init(params, opt)
        out["opt_specs"] = {"m": pspecs, "v": pspecs, "step": ()}
        if psa is not None:
            state = psa_init(params, psa)
            out["psa"] = state
            out["psa_specs"] = {
                part: _tree.unflatten(
                    _tree.flatten_with_names(state[part])[2],
                    [(None,) * leaf.dim() for leaf in
                     _tree.tree_leaves(state[part])])
                for part in ("proj", "ef")}
    else:
        state = init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                  device=META)
        out["decode_state"] = state
        out["decode_state_specs"] = shd.decode_state_specs(
            state, cfg, mesh, shape.global_batch)
    return out


def _alloc(nbytes: int) -> int:
    return -(-nbytes // ALLOC_GRANULE) * ALLOC_GRANULE if nbytes else 0


def _rank_bytes(tree, specs, mesh) -> Dict[str, int]:
    """A rank's bytes of ``tree``'s tensor leaves cut by ``specs``: raw,
    and as the caching allocator rounds each block (``alloc``)."""
    raw = alloc = 0
    for leaf, spec in zip(_tree.tree_leaves(tree), shd.spec_leaves(specs)):
        if not isinstance(leaf, torch.Tensor):
            continue
        n = int(np.prod(shd.local_shape(leaf.shape, spec, mesh),
                        dtype=np.int64)) * leaf.element_size()
        raw += n
        alloc += _alloc(n)
    return {"bytes": raw, "alloc": alloc}


def memory_plan(cfg: ModelConfig, shape: ShapeConfig, mesh,
                opt: AdamWConfig, *, psa: Optional[PSAConfig] = None
                ) -> Dict[str, Any]:
    """A rank's bytes of each part of a cell's state (``bytes``, ``alloc``
    each), their total and whether it fits in ``HW.HBM_BYTES``."""
    st = abstract_state(cfg, shape, mesh, opt, psa=psa)
    inputs, ispecs = input_specs(cfg, shape, mesh)
    plan = {"params": _rank_bytes(st["params"], st["params_specs"], mesh)}
    for part in ("opt", "decode_state"):
        if part in st:
            plan[part] = _rank_bytes(st[part], st[part + "_specs"], mesh)
    if "psa" in st:
        plan["psa"] = {k: sum(_rank_bytes(st["psa"][p], st["psa_specs"][p],
                                          mesh)[k] for p in ("proj", "ef"))
                       for k in ("bytes", "alloc")}
    plan["inputs"] = _rank_bytes(inputs, ispecs, mesh)
    total = {k: sum(v[k] for v in plan.values()) for k in ("bytes", "alloc")}
    return {**plan, "total": total, "fits": total["alloc"] <= HW.HBM_BYTES,
            "hbm_bytes": HW.HBM_BYTES}


def _moment_dtype(cfg: ModelConfig) -> str:
    return "bfloat16" if cfg.param_count() > 2e11 else "float32"


def run_cell(arch: str, shape_id: str, *, multi_pod: bool,
             psa: bool = False, remat=True) -> Dict[str, Any]:
    """One cell's per-rank plan, roofline terms and wire bytes on the
    production mesh (16, 16), or (2, 16, 16) with ``multi_pod``. ``psa``:
    add the PSA state of a train cell (the multi-pod path). ``remat``: the
    train step's (``--no-remat``: ``False``)."""
    t0 = time.perf_counter()
    cfg = get_arch(arch)
    shape = SHAPES[shape_id]
    if shape_id == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape_id, "multi_pod": multi_pod,
                "status": "skipped",
                "reason": "full-attention arch: 500k decode cache infeasible"}
    mesh = make_production_mesh(multi_pod=multi_pod)
    opt = AdamWConfig(moment_dtype=_moment_dtype(cfg))
    use_psa = psa and shape.kind == "train"
    plan = memory_plan(cfg, shape, mesh, opt,
                       psa=get_psa_config() if use_psa else None)
    roof = roofline_cell(arch, shape, mesh=mesh, cfg=cfg, remat=remat)
    return {
        "arch": arch, "shape": shape_id, "multi_pod": multi_pod,
        "psa": use_psa, "remat": remat, "status": "ok",
        "n_devices": mesh.size,
        "mesh": mesh.shape, "moment_dtype": opt.moment_dtype,
        "per_rank": plan, "fits": plan["fits"],
        "model_flops": model_flops(cfg, shape),
        "roofline": roof["roofline"], "mfu_at_bound": roof["mfu_at_bound"],
        "wire_bytes_per_dev": roof["wire_bytes_per_dev"],
        "wire_by_axis": roof["wire_by_axis"],
        "cross_pod_bytes": roof["cross_pod_bytes"],
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "seconds": time.perf_counter() - t0,
    }


def run_all(out_dir: Optional[str] = None, remat=True):
    """Every cell of ``valid_cells()`` on both production meshes (PSA
    state on the multi-pod train cells): one result a cell."""
    results = []
    for cell in valid_cells():
        for mp in (False, True):
            res = run_cell(cell["arch"], cell["shape"], multi_pod=mp,
                           psa=mp, remat=remat)
            results.append(res)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                tag = f"{cell['arch']}__{cell['shape']}__" \
                      f"{'mp' if mp else 'sp'}"
                with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=1)
    return results


def _summary(res: Dict[str, Any]) -> Dict[str, Any]:
    if res["status"] != "ok":
        return {k: res[k] for k in ("arch", "shape", "multi_pod", "status")}
    gib = 2 ** 30
    return {"arch": res["arch"], "shape": res["shape"],
            "multi_pod": res["multi_pod"], "status": "ok",
            "per_rank_gib": {k: v["alloc"] / gib
                             for k, v in res["per_rank"].items()
                             if isinstance(v, dict) and "alloc" in v},
            "fits": res["fits"], "dominant": res["roofline"]["dominant"],
            "bound_s": res["roofline"]["bound_s"],
            "wire_bytes_per_dev": res["wire_bytes_per_dev"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--psa", action="store_true",
                    help="add the PSA state of a train cell")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", help="with --all: one JSON file a cell here")
    ap.add_argument("--no-remat", action="store_true",
                    help="train steps without remat (the reference's flag)")
    args = ap.parse_args(argv)
    remat = not args.no_remat
    if args.all:
        t0 = time.perf_counter()
        results = run_all(args.out, remat=remat)
        for res in results:
            print(json.dumps(_summary(res)))
        ok = sum(r["status"] == "ok" for r in results)
        print(json.dumps({"cells": len(results), "ok": ok,
                          "skipped": len(results) - ok,
                          "fit": sum(bool(r.get("fits")) for r in results),
                          "seconds": time.perf_counter() - t0}))
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    print(json.dumps(run_cell(args.arch, args.shape,
                              multi_pod=args.multipod, psa=args.psa,
                              remat=remat), indent=1))


if __name__ == "__main__":
    main()
