"""The sharded train step over gloo ranks (CPU), against one process and
the reference.

One spawn of 4 gloo ranks lays a (2, 2) ("data", "model") mesh out. Each
rank holds its blocks of the parameters and AdamW moments
(``models/sharding.shard_tree`` by ``param_specs``) and runs
``make_sharded_train_step`` for STEPS steps on its batch shard, on reduced
h2o-danube-1.8b and on reduced phi3.5-moe (f32). Held: the first loss
against the reference's ``loss_fn`` on the global batch (its MoE routing
each data shard's tokens on their own, ``act_specs["moe"]["n_dp"]`` = 2,
at a capacity where that routing drops other pairs than a global one),
the dense model's losses and gathered parameters against the port's
one-process ``make_train_step``, each rank's wire bytes against
``roofline.step_wire_bytes`` and its stored bytes against
``dryrun.memory_plan``; then a checkpoint written from the (2, 2) mesh is
re-cut onto (4, 1) by ``CheckpointManager.restore(mesh=, specs=)``.

The ranks start by ``spawn`` and import this module: it imports no JAX at
module level (the reference's loss is computed in the fixture).
Tolerances: F32_TOL, relative, on losses (f32 sums in another order);
parameters after AdamW within STEP_TOL of their leaf's largest
(test_torch_train.py's reason: a first step moves an element by ~lr
whatever the size of its gradient).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch import configs as tcfg
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tt
from repro_torch.optim.adamw import AdamWConfig

F32_TOL = 2e-5
STEP_TOL = 1e-4
SHARDED = ("h2o-danube-1.8b", "phi3.5-moe-42b-a6.6b")
SB, SS, STEPS = 4, 16, 2
# phi3.5's experts at capacity 0.5: per-shard capacities drop other pairs
# than one global routing would, so the data-shard routing shows
MOE_CF = 0.5


def _cfg(configs, aid):
    """A reduced config, its MoE at MOE_CF (either package's configs)."""
    cfg = configs.reduced_config(configs.get_arch(aid))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_CF))
    return cfg


def _rank(rank, world, dev, work):
    """(2, 2) mesh: the wire counter on its own, then each SHARDED model's
    sharded step, then the checkpoint re-cut onto (4, 1)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_sharded_train_step

    mesh = make_mesh((("data", 2), ("model", 2)), device=dev)
    shape = shd.MeshShape.from_mesh(mesh)
    out = {"coords": mesh.coords}
    # the counter: one collective of each kind on the data axis
    ax = mesh.axis("data")
    ax.all_reduce_(torch.ones(10))
    ax.all_gather(torch.ones(6))
    ax.exchange(torch.ones(3), [1 - ax.index])
    out["swapped"] = ax.all_to_all(torch.full((2, 3), float(ax.index)))
    out["scattered"] = ax.reduce_scatter(torch.arange(8.0).reshape(2, 4),
                                         dim=1)
    out["counter"] = dict(ax.wire_bytes)
    ax.wire_bytes = {k: 0.0 for k in ax.wire_bytes}
    opt = AdamWConfig(warmup_steps=1)
    for aid in SHARDED:
        cfg = _cfg(tcfg, aid)
        full = torch.load(os.path.join(work, f"{aid}.pt"))
        pspecs = shd.param_specs(full, cfg, shape)
        params = shd.shard_tree(full, pspecs, shape, mesh.coords)
        opt_state = adamw_init(params, opt)
        before = {a: dict(g.wire_bytes) for a, g in mesh.groups.items()}
        step = make_sharded_train_step(cfg, opt, mesh, global_batch=SB)
        losses, norms = [], []
        for t in range(STEPS):
            batch = torch.load(os.path.join(work, f"{aid}_batch{t}.pt"))
            local = shd.shard_tree(batch, shd.batch_specs(cfg, shape, SB),
                                   shape, mesh.coords)
            params, opt_state, met = step(params, opt_state, local)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        out[aid] = {
            "losses": losses, "grad_norms": norms,
            "local_bytes": sum(x.numel() * x.element_size() for x in
                               _tree.tree_leaves(params)),
            "wire": {a: {k: g.wire_bytes[k] - before[a][k]
                         for k in g.wire_bytes}
                     for a, g in mesh.groups.items()},
            "params": shd.gather_tree(params, pspecs, mesh)}
        if aid == SHARDED[0]:
            gathered = out[aid]["params"]
            if rank == 0:
                CheckpointManager(os.path.join(work, "ckpt")).save(
                    STEPS, gathered)
            torch.distributed.barrier()
            other = make_mesh((("data", 4), ("model", 1)), device=dev)
            got, _ = CheckpointManager(os.path.join(work, "ckpt")).restore(
                gathered, mesh=other,
                specs=shd.param_specs(full, cfg, shd.MeshShape.from_mesh(
                    other)))
            want = shd.shard_tree(gathered, shd.param_specs(
                full, cfg, shd.MeshShape.from_mesh(other)),
                shd.MeshShape.from_mesh(other), other.coords)
            out["restored_equal"] = all(
                torch.equal(a, b) for a, b in zip(
                    _tree.tree_leaves(got), _tree.tree_leaves(want)))
            out["restored_coords"] = other.coords
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The ranks' results, the one-process steps and the reference's
    losses on the same parameters and batches."""
    import jax
    from repro import configs as jcfg
    from repro.train.step import loss_fn as jloss_fn
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import loss_fn, make_train_step
    work = str(tmp_path_factory.mktemp("sharded"))
    one = {}
    for aid in SHARDED:
        tc, jc = _cfg(tcfg, aid), _cfg(jcfg, aid)
        params = tt.init_params(torch.Generator().manual_seed(0), tc,
                                device="cpu")
        jparams = tt.tree_map(lambda t: t.numpy(), params)
        torch.save(params, os.path.join(work, f"{aid}.pt"))
        batches = [make_lm_batch(tc, 0, t, SB, SS, device="cpu")
                   for t in range(STEPS)]
        for t, b in enumerate(batches):
            torch.save(b, os.path.join(work, f"{aid}_batch{t}.pt"))
        # the reference's loss on the first batch, its MoE routed per data
        # shard as activation_specs gives it on a (2, 2) mesh
        n_dp = 2 if jc.moe is not None else 1
        aspecs = {"act": None, "logits": None, "attn_q": None,
                  "attn_kv": None,
                  "moe": {"dp": None, "e": None, "n_dp": n_dp}}
        jb = {k: v.numpy() for k, v in batches[0].items()}
        ref_loss = float(jax.jit(lambda p, b: jloss_fn(
            p, b, jc, remat=False, act_specs=aspecs))(jparams, jb))
        tspecs = {"moe": {"n_dp": n_dp}}
        port_loss = float(loss_fn(params, batches[0], tc, act_specs=tspecs))
        # the one-process step routes all the batch's tokens together: with
        # the MoE it is held on the dense model only
        opt = AdamWConfig(warmup_steps=1)
        step = make_train_step(tc, opt, donate=False)
        p, o, losses = params, adamw_init(params, opt), []
        for b in batches:
            p, o, met = step(p, o, b)
            losses.append(float(met["loss"]))
        one[aid] = {"ref_loss": ref_loss, "port_loss": port_loss,
                    "losses": losses, "params": p, "cfg": tc}
    ranks = spawn_ranks(_rank, 4, backend="gloo", device="cpu",
                        args=(work,))
    return ranks, one


@pytest.mark.parametrize("aid", SHARDED)
def test_sharded_loss_matches_reference_and_one_process(sharded, aid):
    ranks, one = sharded
    o = one[aid]
    np.testing.assert_allclose(o["port_loss"], o["ref_loss"], rtol=F32_TOL)
    for r in ranks:
        np.testing.assert_allclose(r[aid]["losses"][0], o["ref_loss"],
                                   rtol=F32_TOL)
        assert r[aid]["losses"] == ranks[0][aid]["losses"]
    if o["cfg"].moe is None:
        np.testing.assert_allclose(ranks[0][aid]["losses"], o["losses"],
                                   rtol=F32_TOL)


def test_sharded_step_parameters_match_one_process(sharded):
    """STEPS steps of the dense model: every gathered parameter within
    STEP_TOL of its leaf's largest."""
    ranks, one = sharded
    aid = SHARDED[0]
    want = tt.tree_leaves(one[aid]["params"])
    for r in ranks:
        for got, w in zip(tt.tree_leaves(r[aid]["params"]), want):
            err = float((got - w).abs().max())
            assert err <= STEP_TOL * float(w.abs().max()) + 1e-7


@pytest.mark.parametrize("aid", SHARDED)
def test_sharded_step_wire_and_stored_bytes_match_the_plan(sharded, aid):
    """Each rank's counted wire bytes equal ``step_wire_bytes`` a step;
    its stored parameter bytes equal the dry run's plan for (2, 2)."""
    ranks, one = sharded
    cfg = one[aid]["cfg"]
    mesh = shd.MeshShape.of(("data", 2), ("model", 2))
    shape = ShapeConfig("sharded", SS, SB, "train")
    want = roofline.step_wire_bytes(cfg, shape, mesh)
    plan = dryrun.memory_plan(cfg, shape, mesh, AdamWConfig(warmup_steps=1))
    for r in ranks:
        for a in ("data", "model"):
            got = r[aid]["wire"][a]
            assert got["all-gather"] == STEPS * want[a]["all-gather"]
            assert got["all-reduce"] == STEPS * want[a]["all-reduce"]
            assert got["collective-permute"] == 0.0
        assert r[aid]["local_bytes"] == plan["params"]["bytes"]
    assert want["data"]["all-reduce"] > 0 and want["model"]["all-reduce"] == 0


def test_wire_counter_uses_the_reference_factors(sharded):
    ranks, _ = sharded
    for r in ranks:
        assert r["counter"] == {"all-reduce": 2 * 1 / 2 * 40,
                                "all-gather": 1 / 2 * 2 * 24,
                                "reduce-scatter": 1 / 2 * 32,
                                "all-to-all": 1 / 2 * 24,
                                "collective-permute": 12.0}
        assert torch.equal(r["swapped"],
                           torch.tensor([[0.0] * 3, [1.0] * 3]))
        # the sum over both data ranks, this rank's half of the columns
        half = 2 * torch.arange(8.0).reshape(2, 4)
        col = r["coords"]["data"] * 2
        assert torch.equal(r["scattered"], half[:, col:col + 2])


def test_restore_recuts_the_2x2_save_onto_4x1(sharded):
    ranks, _ = sharded
    assert sorted(r["restored_coords"]["data"] for r in ranks) == [0, 1, 2, 3]
    assert all(r["restored_equal"] for r in ranks)
