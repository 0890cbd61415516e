"""Gossip across processes (CPU, gloo): the port's ``SpmdConsensus``,
``two_level_reduce`` and ``sdot_spmd`` over 8 rank processes against the
reference's over 8 placeholder XLA devices, on the same inputs.

The reference runs once, in one subprocess with
``--xla_force_host_platform_device_count=8`` (the pattern of
tests/test_spmd.py), and writes its inputs and outputs to an npz. The
port's ranks are spawned once (``launch/mesh.spawn_ranks``, gloo,
``device="cpu"``), read the same inputs, and each returns its own results.
This file imports no JAX: the reference lives in the subprocess.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.consensus import DenseConsensus, consensus_schedule
from repro_torch.core.sdot import sdot
from repro_torch.core.topology import Graph
from repro_torch.launch.mesh import spawn_ranks

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N = 8
GOSSIP_CASES = [("ring", 1), ("ring", 5), ("ring", 20), ("er", 12)]
GOSSIP_TOL = 1e-5          # f32 rounds summed in another order
TRACE_RTOL, TRACE_ATOL = 1e-4, 1e-6
Q_TOL = 1e-5
TWO_LEVEL_TOL = 1e-4       # 60 rounds on ring(4) from the exact pod sums

REFERENCE = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core.compat import shard_map
    from repro.core.consensus import (SpmdConsensus, consensus_schedule,
                                      two_level_reduce)
    from repro.core.linalg import eigh_topr, orthonormal_init
    from repro.core.sdot import sdot_spmd
    from repro.core.topology import erdos_renyi, ring
    from repro.data.pipeline import gaussian_eigengap_data, partition_samples

    out = {}
    n = 8
    mesh = Mesh(np.array(jax.devices()), ("nodes",))
    graphs = {"ring": ring(n), "er": erdos_renyi(n, 0.5, seed=3)}
    for name, g in graphs.items():
        out[f"adj_{name}"] = g.adjacency
    z_ring = np.random.default_rng(0).standard_normal((n, 6, 3)).astype(
        np.float32)
    z_er = np.random.default_rng(1).standard_normal((n, 5, 2)).astype(
        np.float32)
    out["z_ring"], out["z_er"] = z_ring, z_er
    for name, t_c in (("ring", 1), ("ring", 5), ("ring", 20), ("er", 12)):
        spmd = SpmdConsensus(mesh, "nodes", graph=graphs[name])
        z = z_ring if name == "ring" else z_er
        out[f"gossip_{name}_{t_c}"] = np.asarray(
            spmd.build_debiased_sum(t_c)(jnp.asarray(z)))

    d, r = 16, 3
    x, _, _ = gaussian_eigengap_data(d, n * 400, r, 0.7, seed=0)
    covs = jnp.stack([b @ b.T / b.shape[1] for b in partition_samples(x, n)])
    _, q_true = eigh_topr(covs.sum(0), r)
    q_init = orthonormal_init(jax.random.PRNGKey(0), d, r)
    out["covs"], out["q_true"] = np.asarray(covs), np.asarray(q_true)
    out["q_init"] = np.asarray(q_init)
    sched = consensus_schedule("lin2", 12, cap=30)
    out["sched"] = sched
    for name, g in graphs.items():
        res = sdot_spmd(covs=covs, engine=SpmdConsensus(mesh, "nodes",
                                                        graph=g),
                        r=r, t_outer=12, schedule=sched, q_init=q_init,
                        q_true=q_true)
        out[f"sdot_{name}_trace"] = res.error_trace
        out[f"sdot_{name}_q"] = np.asarray(res.q_nodes)
        led = res.ledger
        out[f"sdot_{name}_ledger"] = np.array(
            [led.p2p, led.matrices, led.scalars, led.payload_bytes])

    mesh2 = Mesh(np.array(jax.devices()).reshape(4, 2), ("pod", "data"))
    spmd2 = SpmdConsensus(mesh2, "pod", graph=ring(4))
    z2 = np.random.default_rng(0).standard_normal((4, 2, 5, 3)).astype(
        np.float32)
    def f(zloc):
        return two_level_reduce(zloc[0, 0], intra_axis="data", inter=spmd2,
                                t_c=60)[None, None]
    spec = P("pod", "data", None, None)
    out["z2"] = z2
    out["two_level"] = np.asarray(jax.jit(shard_map(
        f, mesh=mesh2, in_specs=(spec,), out_specs=spec))(jnp.asarray(z2)))
    np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spmd_ref") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        path], capture_output=True, text=True, timeout=420,
                       env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return path


@pytest.fixture(scope="module")
def reference(reference_path):
    return dict(np.load(reference_path))


def _rank(rank, world, dev, ref_path):
    """Everything the port computes, on one rank."""
    from repro_torch.core.consensus import SpmdConsensus, two_level_reduce
    from repro_torch.core.sdot import sdot_spmd
    from repro_torch.core.topology import ring
    from repro_torch.launch.mesh import make_mesh, make_test_mesh

    ref = dict(np.load(ref_path))
    mesh = make_test_mesh(device=dev)
    graphs = {k: Graph(ref[f"adj_{k}"]) for k in ("ring", "er")}
    out = {"gossip": {}, "sdot": {}}
    for name, t_c in GOSSIP_CASES:
        spmd = SpmdConsensus(mesh, "nodes", graph=graphs[name])
        z = torch.from_numpy(ref[f"z_{name}"][rank])
        out["gossip"][(name, t_c)] = spmd.build_debiased_sum(t_c)(z)
    for name, g in graphs.items():
        res = sdot_spmd(covs=torch.from_numpy(ref["covs"][rank]),
                        engine=SpmdConsensus(mesh, "nodes", graph=g),
                        r=3, t_outer=12, schedule=ref["sched"],
                        q_init=torch.from_numpy(ref["q_init"]),
                        q_true=torch.from_numpy(ref["q_true"]))
        led = res.ledger
        out["sdot"][name] = (res.error_trace, res.q_nodes,
                             [led.p2p, led.matrices, led.scalars,
                              led.payload_bytes])
    # q_init drawn by every rank from seed 5: t_outer = 0 gathers them
    out["q_init_stack"] = sdot_spmd(
        covs=torch.from_numpy(ref["covs"][rank]),
        engine=SpmdConsensus(mesh, "nodes"), r=3, t_outer=0,
        seed=5).q_nodes
    mesh2 = make_mesh((("pod", 4), ("data", 2)), device=dev)
    spmd2 = SpmdConsensus(mesh2, "pod", graph=ring(4))
    i, j = mesh2.coords["pod"], mesh2.coords["data"]
    out["two_level"] = two_level_reduce(
        torch.from_numpy(ref["z2"][i, j]), intra_axis="data", inter=spmd2,
        t_c=60)
    out["mesh2"] = {"coords": (i, j),
                    "pod_ranks": mesh2.axis("pod").ranks,
                    "data_ranks": mesh2.axis("data").ranks,
                    "staged": mesh.host_staged_bytes
                    + mesh2.host_staged_bytes}
    return out


@pytest.fixture(scope="module")
def port(reference_path):
    # the ranks read the npz themselves: a dict of arrays sent to each
    # spawned process costs seconds
    return spawn_ranks(_rank, N, device="cpu", args=(reference_path,))


@pytest.mark.parametrize("name,t_c", GOSSIP_CASES)
def test_spmd_gossip_matches_reference(reference, port, name, t_c):
    got = np.stack([r["gossip"][(name, t_c)].numpy() for r in port])
    np.testing.assert_allclose(got, reference[f"gossip_{name}_{t_c}"],
                               rtol=GOSSIP_TOL, atol=GOSSIP_TOL)


@pytest.mark.parametrize("name,t_c", GOSSIP_CASES)
def test_spmd_gossip_matches_dense_engine(reference, port, name, t_c):
    """The port's own single-process engine on the stacked blocks."""
    dense = DenseConsensus(Graph(reference[f"adj_{name}"]), device="cpu")
    want = dense.run_debiased(torch.from_numpy(reference[f"z_{name}"]), t_c)
    got = np.stack([r["gossip"][(name, t_c)].numpy() for r in port])
    np.testing.assert_allclose(got, want.numpy(), rtol=GOSSIP_TOL,
                               atol=GOSSIP_TOL)


@pytest.mark.parametrize("name", ["ring", "er"])
def test_sdot_spmd_matches_reference(reference, port, name):
    for r in port:
        trace, q_nodes, ledger = r["sdot"][name]
        np.testing.assert_allclose(trace, reference[f"sdot_{name}_trace"],
                                   rtol=TRACE_RTOL, atol=TRACE_ATOL)
        np.testing.assert_allclose(q_nodes.numpy(),
                                   reference[f"sdot_{name}_q"], rtol=0,
                                   atol=Q_TOL)
        assert ledger == reference[f"sdot_{name}_ledger"].tolist()


@pytest.mark.parametrize("name", ["ring", "er"])
def test_sdot_spmd_matches_fused_dense_sdot(reference, port, name):
    """Every rank's result against the port's fused S-DOT over a
    ``DenseConsensus`` on the stacked covs, from the same q_init."""
    want = sdot(covs=torch.from_numpy(reference["covs"]),
                engine=DenseConsensus(Graph(reference[f"adj_{name}"]),
                                      device="cpu"),
                r=3, t_outer=12, schedule=reference["sched"],
                q_init=torch.from_numpy(reference["q_init"]),
                q_true=torch.from_numpy(reference["q_true"]), device="cpu")
    led = want.ledger
    for r in port:
        trace, q_nodes, ledger = r["sdot"][name]
        np.testing.assert_allclose(trace, want.error_trace, rtol=TRACE_RTOL,
                                   atol=TRACE_ATOL)
        np.testing.assert_allclose(q_nodes.numpy(), want.q_nodes.numpy(),
                                   rtol=0, atol=Q_TOL)
        assert ledger == [led.p2p, led.matrices, led.scalars,
                          led.payload_bytes]


def test_sdot_spmd_schedule_is_the_reference_lin2_cap(reference):
    np.testing.assert_array_equal(consensus_schedule("lin2", 12, cap=30),
                                  reference["sched"])


def test_ranks_draw_the_same_q_init_bits(port):
    """With no q_init, every rank draws it from a CPU generator seeded by
    ``seed``: the gathered stack holds one matrix N times, bit for bit, on
    every rank, and it is orthonormal."""
    first = port[0]["q_init_stack"]
    for r in port:
        stack = r["q_init_stack"]
        assert stack.shape == (N, 16, 3)
        for i in range(N):
            assert torch.equal(stack[i], first[0])
    q = first[0].double()
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(3), atol=1e-6)


def test_two_level_reduce_matches_reference_and_exact_sum(reference, port):
    want = reference["z2"].sum(axis=(0, 1))
    for r in port:
        i, j = r["mesh2"]["coords"]
        got = r["two_level"].numpy()
        np.testing.assert_allclose(got, reference["two_level"][i, j],
                                   rtol=TWO_LEVEL_TOL, atol=TWO_LEVEL_TOL)
        np.testing.assert_allclose(got, want, rtol=TWO_LEVEL_TOL,
                                   atol=TWO_LEVEL_TOL)


def test_mesh_layout_is_row_major_and_cpu_is_not_staged(port):
    """(4, 2) mesh: global rank 2 i + j sits at (i, j); its pod axis holds
    ranks j, 2 + j, 4 + j, 6 + j, its data axis 2 i, 2 i + 1. CPU tensors
    under gloo go straight to the backend: nothing staged."""
    for rank, r in enumerate(port):
        m = r["mesh2"]
        i, j = m["coords"]
        assert (i, j) == divmod(rank, 2)
        assert m["pod_ranks"] == tuple(2 * k + j for k in range(4))
        assert m["data_ranks"] == (2 * i, 2 * i + 1)
        assert m["staged"] == 0


def _failing_rank(rank, world, dev):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def test_spawn_ranks_raises_when_a_rank_fails():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        spawn_ranks(_failing_rank, 2, device="cpu")
