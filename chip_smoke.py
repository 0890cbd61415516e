"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

* ``build``: compiles every CUDA source of ``src/repro_torch/kernels/csrc``
  with nvcc (one process per source, in parallel) and reports the compiler's
  register / shared-memory report and the card (nvidia-smi).
* ``kernels``: every ported kernel against its plain PyTorch version on the
  card, at the shapes the main path gives it, with its median time, the
  plain version's time, one PyTorch library call's time as a yardstick, and
  the least time the card could take (its bound).
* ``sdot_dense``: S-DOT (t_c = 50) and SA-DOT (2t+1, capped at 50) at the
  paper's CIFAR-10 width: d = 1024, r = 7, N = 20 nodes of erdos_renyi(20,
  0.25, seed=1), T_o = 100, the full 50,000-sample training-set size (2,500
  samples a node), data from gaussian_eigengap_data(gap 0.7, seed 0).
  Checks: final mean subspace error <= 1e-4 against a float64 eigh, one
  gram-apply launch per outer iteration, the closed-form ledger, and the
  explained variance of the estimate on the whole data (single-node
  gram-apply) against the top-r eigenvalues.
* ``profile``: device time by kernel over a short S-DOT run (torch.profiler),
  and the device's busy share of that run's wall time.
* ``fdot_dense``: F-DOT (Alg. 2) on the same X, spread by features over the
  same 20-node graph (19 slabs of 51 features and one of 55, all 50,000
  samples each), r = 7, T_o = 100, t_c = t_c_qr = 50, under the constant
  schedule and 2t+1 capped at 50. Checks: final mean subspace error <= 1e-4,
  q_full orthonormal to 1e-5, one launch of each slab kernel per outer
  iteration, the closed-form ledger, and F-DOT's subspace within 1e-4 of
  S-DOT's consensus estimate.
* ``bdot_dense``: B-DOT on the same X over a 4 x 5 grid (256 features x
  10,000 samples a node), column engines erdos_renyi(4, 0.7, seed=j), row
  engines erdos_renyi(5, 0.7, seed=10 + i), the same two schedules and
  checks, with one launch of each grid kernel per outer iteration.
* ``profile_fdot``, ``profile_bdot``: the profile of a T_o = 20 run of each.
* ``sdot_sparse``: watts_strogatz(4096, k=6, p=0.1, seed=1) at MNIST width
  (d = 784, r = 5, 60,000 samples, 14 a node), T_o = 5, t_c = 20. The
  default engine must pick ELL gossip; the per-node estimates must agree
  with the dense matmul engine; a bf16-payload run must be finite and
  priced at 2 bytes per element.

Launch counts are set to 0 just before each phase of the main path and read
just after it; launches made to compare or time a kernel do not count.
Before the last line it prints ``{"kernels": [...]}`` and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``. Any failed
build, launch or check exits nonzero. With no CUDA device it exits 2 and
prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
GRAM_TOL = 1e-5               # f32 sums in another order, relative to |V|
SLAB_TOL = 1e-5               # the same, relative to max |Z| or |V|
ELL_TOL = 1e-6                # same (quantised) source both sides, rel. |out|
SUBSPACE_TOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, batches: int = 5, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around a batch of ``reps``
    back-to-back calls, divided by ``reps`` (the host queues ahead of the
    card, so the batch times the card and not each launch), median of
    ``batches`` batches."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(text: str):
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln]


def profile_phase(run, phase: str = "profile",
                  what: str = "sdot_dense S-DOT, T_o = 20, t_c = 50") -> dict:
    """Device time by kernel over one short run, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    run()                                             # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}   # device kernels only: an aten op's device time repeats them
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us > 0:
            by_name[evt.key] = (dev_us / 1e3, evt.count)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"phase": phase, "what": what,
            "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if by_name else "not measured",
            "device_busy_share": busy_ms / wall_ms if by_name else
            "not measured",
            "top_kernels": [{"name": k[:80], "ms": v[0], "calls": v[1]}
                            for k, v in top]}


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import topology
    from repro_torch.core.bdot import bdot, pad_grid_blocks
    from repro_torch.core.consensus import (DenseConsensus, SparseConsensus,
                                            consensus_schedule)
    from repro_torch.core.fdot import fdot, pad_feature_slabs
    from repro_torch.core.linalg import cholesky_qr2, orthonormal_init
    from repro_torch.core.metrics import subspace_error
    from repro_torch.core.sdot import _stack_data, sadot, sdot
    from repro_torch.data.pipeline import (gaussian_eigengap_data,
                                           partition_features,
                                           partition_samples)
    from repro_torch.kernels import _build, ops, ref

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = nvidia_smi()

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.BUILD_SECONDS, "card": card,
          "ptxas": {name: ptxas_summary(p.with_suffix(".ptxas.txt").read_text())
                    for name, p in libs.items()}})

    # -- the main path's data ------------------------------------------------
    t0 = time.perf_counter()
    d, r, n_nodes, n_total, t_outer = 1024, 7, 20, 50_000, 100
    x, _, _ = gaussian_eigengap_data(d, n_total, r, 0.7, seed=0, device=dev)
    blocks = partition_samples(x, n_nodes)
    x64 = x.double()
    m = sum(b.double() @ b.double().T / b.shape[1] for b in blocks)
    evecs = torch.linalg.eigh(m)[1]
    q_true = evecs[:, -r:].flip(-1).float()
    top_var = float(torch.linalg.eigvalsh(x64 @ x64.T / n_total)[-r:].sum())
    del x64, m
    graph = topology.erdos_renyi(n_nodes, 0.25, seed=1)
    fslabs = partition_features(x, n_nodes)          # 19 x 51 rows + 1 x 55
    g_rows, g_cols = 4, 5
    grid = [partition_samples(sl, g_cols)
            for sl in partition_features(x, g_rows)]  # (256, 10000) a node

    ds, rs, n_sp, n_sp_total, t_sp = 784, 5, 4096, 60_000, 5
    xs, _, _ = gaussian_eigengap_data(ds, n_sp_total, rs, 0.7, seed=0,
                                      device=dev)
    sp_blocks = partition_samples(xs, n_sp)
    sp_graph = topology.watts_strogatz(n_sp, k=6, p=0.1, seed=1)
    sp_eng = DenseConsensus(sp_graph, device=dev)
    check(sp_eng.is_sparse, "DenseConsensus(sparse=None) did not pick the "
          "ELL path for watts_strogatz(4096)")
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "sparse_ell_width": sp_eng._w.ell_width,
          "sparse_nnz": sp_eng._w.nnz})

    # -- kernels vs plain versions, at the main path's shapes ----------------
    gen = torch.Generator(device=dev).manual_seed(0)
    x_stack, n_true = _stack_data(blocks, dev)
    q_stack = torch.linalg.qr(torch.randn((n_nodes, d, r), generator=gen,
                                          device=dev))[0].contiguous()
    rows = {}

    def record(name, source, replaces, kernel, plain, library, nbytes, flops,
               tol, note):
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= tol * scale, f"{name}: max abs err {err} > {tol} x {scale}")
        b_ms, b_by = bound(nbytes, flops)
        rows[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if library is None else time_ms(library),
            "rel_err": err / scale, "tolerance": tol, "tolerance_reason": note,
        }

    f32 = 4
    record("batched_gram_apply", "src/repro_torch/kernels/csrc/gram_update.cu",
           "src/repro/kernels/gram_update.py:102",
           lambda: ops.batched_gram_apply(x_stack, q_stack, n_true),
           lambda: ref.batched_gram_apply_ref(x_stack, q_stack, n_true),
           lambda: torch.bmm(x_stack, torch.bmm(x_stack.mT, q_stack)),
           f32 * (x_stack.numel() + 2 * q_stack.numel() + n_nodes),
           4.0 * x_stack.numel() * r, GRAM_TOL,
           "f32 sums in another order than cuBLAS; relative to max |V|")
    x_one, q_one = blocks[0].contiguous(), q_stack[0]
    record("gram_apply", "src/repro_torch/kernels/csrc/gram_update.cu",
           "src/repro/kernels/gram_update.py:51",
           lambda: ops.gram_apply(x_one, q_one),
           lambda: ref.gram_apply_ref(x_one, q_one),
           lambda: x_one @ (x_one.T @ q_one),
           f32 * (x_one.numel() + 2 * q_one.numel()), 4.0 * x_one.numel() * r,
           GRAM_TOL, "f32 sums in another order than cuBLAS; relative to "
           "max |V|")
    sw = sp_eng._w
    k_payload = ds * rs
    z = torch.randn((n_sp, k_payload), generator=gen, device=dev)
    z_bf16 = z.to(torch.bfloat16)
    w_csr = sw.to_dense().to_sparse_csr()
    edges = float(sw.row_nnz.sum())
    ell_meta = f32 * (2 * sw.ell_idx.numel() + n_sp)
    ell_flops = 2.0 * (edges + n_sp) * k_payload
    record("ell_spmm", "src/repro_torch/kernels/csrc/ell_spmm.cu",
           "src/repro/kernels/ell_spmm.py:57",
           lambda: ops.ell_spmm(sw.ell_idx, sw.ell_val, sw.diag, z),
           lambda: ref.ell_spmm_ref(sw.ell_idx, sw.ell_val, sw.diag, z, z),
           lambda: torch.sparse.mm(w_csr, z),
           ell_meta + f32 * 2 * z.numel(), ell_flops, ELL_TOL,
           "f32 FMA chain against the plain gather; relative to max |out|")
    record("ell_spmm_bf16", "src/repro_torch/kernels/csrc/ell_spmm.cu",
           "src/repro/kernels/ell_spmm.py:57",
           lambda: ops.ell_spmm(sw.ell_idx, sw.ell_val, sw.diag, z,
                                payload_dtype="bfloat16"),
           lambda: ref.ell_spmm_ref(sw.ell_idx, sw.ell_val, sw.diag, z,
                                    z.to(torch.bfloat16)),
           None, ell_meta + f32 * 2 * z.numel() + 2 * z_bf16.numel(),
           ell_flops, ELL_TOL, "the same bf16-quantised source on both "
           "sides, so f32-tight; relative to max |out|")
    del z, z_bf16, w_csr

    # the slab kernels at F-DOT's shapes, the grid kernels at B-DOT's
    x_pad = pad_feature_slabs(fslabs)                      # (20, 55, 50000)
    q_pad = torch.randn((n_nodes, x_pad.shape[1], r), generator=gen,
                        device=dev)
    s_slab = torch.randn((n_nodes, n_total, r), generator=gen, device=dev)
    record("batched_slab_tq", "src/repro_torch/kernels/csrc/slab_ops.cu",
           "src/repro/kernels/slab_ops.py:60",
           lambda: ops.batched_slab_tq(x_pad, q_pad),
           lambda: ref.batched_slab_tq_ref(x_pad, q_pad),
           lambda: torch.bmm(x_pad.mT, q_pad),
           f32 * (x_pad.numel() + q_pad.numel() + n_nodes * n_total * r),
           2.0 * x_pad.numel() * r, SLAB_TOL,
           "f32 sums in another order than cuBLAS; relative to max |Z|")
    record("batched_slab_apply", "src/repro_torch/kernels/csrc/slab_ops.cu",
           "src/repro/kernels/slab_ops.py:109",
           lambda: ops.batched_slab_apply(x_pad, s_slab),
           lambda: ref.batched_slab_apply_ref(x_pad, s_slab),
           lambda: torch.bmm(x_pad, s_slab),
           f32 * (x_pad.numel() + s_slab.numel() + q_pad.numel()),
           2.0 * x_pad.numel() * r, SLAB_TOL,
           "f32 sums in another order than cuBLAS; relative to max |V|")
    x_grid = pad_grid_blocks(grid)                         # (4, 5, 256, 10000)
    n_blk = x_grid.shape[3]
    q_grid = torch.randn((g_rows, x_grid.shape[2], r), generator=gen,
                         device=dev)
    s_grid = torch.randn((g_cols, n_blk, r), generator=gen, device=dev)
    record("grid_block_tq", "src/repro_torch/kernels/csrc/slab_ops.cu",
           "src/repro/kernels/slab_ops.py:148",
           lambda: ops.grid_block_tq(x_grid, q_grid),
           lambda: ref.grid_block_tq_ref(x_grid, q_grid),
           lambda: torch.matmul(x_grid.mT, q_grid[:, None]),
           f32 * (x_grid.numel() + q_grid.numel()
                  + g_rows * g_cols * n_blk * r),
           2.0 * x_grid.numel() * r, SLAB_TOL,
           "f32 sums in another order than cuBLAS; relative to max |Z|")
    record("grid_block_apply", "src/repro_torch/kernels/csrc/slab_ops.cu",
           "src/repro/kernels/slab_ops.py:198",
           lambda: ops.grid_block_apply(x_grid, s_grid),
           lambda: ref.grid_block_apply_ref(x_grid, s_grid),
           lambda: torch.matmul(x_grid, s_grid[None]),
           f32 * (x_grid.numel() + s_grid.numel()
                  + g_rows * g_cols * x_grid.shape[2] * r),
           2.0 * x_grid.numel() * r, SLAB_TOL,
           "f32 sums in another order than cuBLAS; relative to max |V|")
    emit({"phase": "kernels",
          "shapes": {"batched_gram_apply": list(x_stack.shape) + [r],
                     "gram_apply": list(x_one.shape) + [r],
                     "ell_spmm": [n_sp, sw.ell_width, k_payload],
                     "batched_slab_tq": list(x_pad.shape) + [r],
                     "batched_slab_apply": list(x_pad.shape) + [r],
                     "grid_block_tq": list(x_grid.shape) + [r],
                     "grid_block_apply": list(x_grid.shape) + [r]},
          "kernels": list(rows.values())})
    del x_pad, q_pad, s_slab, x_grid, q_grid, s_grid

    # -- sdot_dense: the main path at CIFAR-10 width -------------------------
    q_init = orthonormal_init(torch.Generator().manual_seed(0), d, r,
                              device=dev)
    eng = DenseConsensus(graph, device=dev)
    check(not eng.is_sparse, "ER(20) must stay dense")
    runs = {}
    for label, kw in (("sdot_tc50", dict(t_c=50)),
                      ("sadot_lin2_cap50", dict(schedule=consensus_schedule(
                          "lin2", t_outer, cap=50)))):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sdot(data=blocks, engine=eng, r=r, t_outer=t_outer,
                   q_init=q_init, q_true=q_true, device=dev, **kw)
        q_mean = cholesky_qr2(res.q_mean)[0]
        v = ops.gram_apply(x, q_mean)              # explained variance, all data
        explained = float(torch.trace(q_mean.T @ v))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        sched = res.consensus_trace
        sends = float(graph.adjacency.sum()) * float(sched.sum())
        check(res.error_trace.shape == (t_outer,)
              and np.isfinite(res.error_trace).all(), f"{label}: bad trace")
        check(float(res.error_trace[-1]) <= SUBSPACE_TOL,
              f"{label}: final error {res.error_trace[-1]} > {SUBSPACE_TOL}")
        check(launches["batched_gram_apply"] == t_outer,
              f"{label}: {launches['batched_gram_apply']} gram-apply "
              f"launches, expected {t_outer}")
        check(launches["gram_apply"] == 1, f"{label}: gram_apply not launched")
        check(res.ledger.p2p == sends and res.ledger.matrices == sends
              and res.ledger.scalars == sends * d * r
              and res.ledger.payload_bytes == sends * d * r * 4,
              f"{label}: ledger differs from the closed form")
        check(explained >= (1 - SUBSPACE_TOL) * top_var,
              f"{label}: explained variance {explained} < top-r {top_var}")
        if label == "sdot_tc50":
            q_sdot = q_mean
        runs[label] = {"wall_s": wall, "final_err": float(res.error_trace[-1]),
                       "err_at": {str(t): float(res.error_trace[t - 1])
                                  for t in (1, 10, 25, 50, 100)},
                       "rounds": int(sched.sum()), "launches": launches,
                       "explained_over_top_r": explained / top_var}
        for name in ("batched_gram_apply", "gram_apply"):
            rows[name]["launches"] += launches[name]
    emit({"phase": "sdot_dense", "d": d, "r": r, "nodes": n_nodes,
          "samples": n_total, "t_outer": t_outer, "runs": runs})
    emit(profile_phase(lambda: sdot(data=blocks, engine=eng, r=r, t_outer=20,
                                    q_init=q_init, q_true=q_true, device=dev,
                                    t_c=50)))
    del x_stack, q_stack

    # -- fdot_dense / bdot_dense: the same X by features and by blocks -------
    schedules = (("tc50", None),
                 ("lin2_cap50", consensus_schedule("lin2", t_outer, cap=50)))
    t_qr = 50

    def summarise(res, wall, kernels, ledger_want):
        q_full = res.q_full
        return {"wall_s": wall, "final_err": float(res.error_trace[-1]),
                "err_at": {str(t): float(res.error_trace[t - 1])
                           for t in (1, 10, 25, 50, 100)},
                "finite": bool(np.isfinite(res.error_trace).all()
                               and res.error_trace.shape == (t_outer,)),
                "orthonormality_err": float((
                    q_full.T @ q_full - torch.eye(r, device=dev)).abs().max()),
                "subspace_err_vs_sdot": float(subspace_error(q_sdot, q_full)),
                "ledger": [res.ledger.p2p, res.ledger.matrices,
                           res.ledger.scalars, res.ledger.payload_bytes],
                "ledger_closed_form": list(ledger_want),
                "launches": {k: ops.LAUNCHES[k] for k in kernels}}

    def verify(phase, runs):
        """Checks of a phase's runs, made after its line is printed."""
        for label, run in runs.items():
            where = f"{phase} {label}"
            check(run["finite"], f"{where}: bad trace")
            check(run["final_err"] <= SUBSPACE_TOL,
                  f"{where}: final error {run['final_err']} > {SUBSPACE_TOL}")
            check(run["orthonormality_err"] <= 1e-5, f"{where}: q_full off "
                  f"orthonormal by {run['orthonormality_err']}")
            for name, count in run["launches"].items():
                check(count == t_outer, f"{where}: {count} {name} launches, "
                      f"expected {t_outer}")
                rows[name]["launches"] += count
            check(run["ledger"] == run["ledger_closed_form"],
                  f"{where}: ledger differs from the closed form")
            check(run["subspace_err_vs_sdot"] <= SUBSPACE_TOL,
                  f"{where}: subspace error {run['subspace_err_vs_sdot']} "
                  "against S-DOT's estimate")

    def closed_form(terms):
        """(p2p, matrices, scalars, payload_bytes) of gossip terms
        (adjacency, rounds, payload elements), f32 payloads."""
        p2p = scalars = 0.0
        for adj, rounds, payload in terms:
            sends = float(adj.sum()) * float(rounds)
            p2p += sends
            scalars += sends * payload
        return [p2p, p2p, scalars, scalars * 4]

    fdot_runs = {}
    for label, sched in schedules:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fdot(data_blocks=fslabs, engine=eng, r=r, t_outer=t_outer,
                   t_c=50, t_c_qr=t_qr, schedule=sched, q_init=q_init,
                   q_true=q_true, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rounds = sched.sum() if sched is not None else 50 * t_outer
        want = closed_form([(graph.adjacency, rounds, n_total * r),
                            (graph.adjacency, 2 * t_qr * t_outer, r * r)])
        fdot_runs[label] = summarise(
            res, wall, ("batched_slab_tq", "batched_slab_apply"), want)
    emit({"phase": "fdot_dense", "d": d, "r": r, "nodes": n_nodes,
          "slab_rows": sorted({int(b.shape[0]) for b in fslabs}),
          "samples": n_total, "t_outer": t_outer, "runs": fdot_runs})
    verify("fdot_dense", fdot_runs)
    emit(profile_phase(
        lambda: fdot(data_blocks=fslabs, engine=eng, r=r, t_outer=20,
                     t_c=50, q_init=q_init, q_true=q_true, device=dev),
        "profile_fdot", "fdot_dense F-DOT, T_o = 20, t_c = t_c_qr = 50"))

    col_engs = [DenseConsensus(topology.erdos_renyi(g_rows, 0.7, seed=j),
                               device=dev) for j in range(g_cols)]
    row_engs = [DenseConsensus(topology.erdos_renyi(g_cols, 0.7, seed=10 + i),
                               device=dev) for i in range(g_rows)]
    d_i, n_j = grid[0][0].shape
    bdot_runs = {}
    for label, sched in schedules:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bdot(blocks=grid, col_engines=col_engs, row_engines=row_engs,
                   r=r, t_outer=t_outer, t_c=50, t_c_qr=t_qr, schedule=sched,
                   q_init=q_init, q_true=q_true, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rounds = sched.sum() if sched is not None else 50 * t_outer
        want = closed_form(
            [(e.graph.adjacency, rounds, n_j * r) for e in col_engs]
            + [(e.graph.adjacency, rounds, d_i * r) for e in row_engs]
            + [(col_engs[0].graph.adjacency, 2 * t_qr * t_outer, r * r)])
        bdot_runs[label] = summarise(
            res, wall, ("grid_block_tq", "grid_block_apply"), want)
    emit({"phase": "bdot_dense", "d": d, "r": r, "grid": [g_rows, g_cols],
          "block": [int(d_i), int(n_j)], "t_outer": t_outer,
          "runs": bdot_runs})
    verify("bdot_dense", bdot_runs)
    emit(profile_phase(
        lambda: bdot(blocks=grid, col_engines=col_engs, row_engines=row_engs,
                     r=r, t_outer=20, t_c=50, q_init=q_init, q_true=q_true,
                     device=dev),
        "profile_bdot", "bdot_dense B-DOT 4 x 5, T_o = 20, t_c = t_c_qr = 50"))

    # -- sdot_sparse: the large-network path ----------------------------------
    q_init_sp = orthonormal_init(torch.Generator().manual_seed(1), ds, rs,
                                 device=dev)
    common = dict(data=sp_blocks, r=rs, t_outer=t_sp, t_c=20,
                  q_init=q_init_sp, device=dev)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sparse_res = sdot(engine=sp_eng, **common)
    torch.cuda.synchronize()
    wall_sparse = time.perf_counter() - t0
    launches_sparse = dict(ops.LAUNCHES)
    rounds = int(sparse_res.consensus_trace.sum())
    check(launches_sparse["ell_spmm"] == rounds + 20,
          f"sparse: {launches_sparse['ell_spmm']} ELL launches, expected "
          f"{rounds} rounds + 20 debias-table rows")
    check(launches_sparse["batched_gram_apply"] == t_sp,
          "sparse: gram-apply launches != T_o")
    rows["ell_spmm"]["launches"] += launches_sparse["ell_spmm"]
    rows["batched_gram_apply"]["launches"] += launches_sparse[
        "batched_gram_apply"]

    dense_eng = DenseConsensus(sp_graph, sparse=False, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense_res = sdot(engine=dense_eng, **common)
    torch.cuda.synchronize()
    wall_dense = time.perf_counter() - t0
    per_node = subspace_error(dense_res.q_nodes, sparse_res.q_nodes)
    check(bool(torch.isfinite(sparse_res.q_nodes).all()), "sparse: non-finite")
    check(float(per_node.max()) <= SUBSPACE_TOL,
          f"sparse vs dense engine: max per-node subspace error "
          f"{float(per_node.max())}")

    bf_eng = SparseConsensus(sp_graph, payload_dtype="bfloat16", device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    bf_res = sadot(engine=bf_eng, schedule_kind="lin2", cap=20,
                   **{k: v for k, v in common.items() if k != "t_c"})
    torch.cuda.synchronize()
    wall_bf = time.perf_counter() - t0
    launches_bf = dict(ops.LAUNCHES)
    rows["ell_spmm_bf16"]["launches"] += launches_bf["ell_spmm"]
    rows["batched_gram_apply"]["launches"] += launches_bf["batched_gram_apply"]
    check(bool(torch.isfinite(bf_res.q_nodes).all()), "bf16: non-finite")
    check(bf_res.ledger.payload_bytes == 2 * bf_res.ledger.scalars,
          "bf16: ledger does not price 2 bytes per element")
    check(launches_bf["ell_spmm"] > 0, "bf16: ELL kernel not launched")
    emit({"phase": "sdot_sparse", "nodes": n_sp, "d": ds, "r": rs,
          "samples_per_node": sp_blocks[0].shape[1], "t_outer": t_sp,
          "ell_width": sw.ell_width, "rounds": rounds,
          "wall_s": {"sparse_ell": wall_sparse, "dense_matmul": wall_dense,
                     "sadot_bf16": wall_bf},
          "launches": {"f32": launches_sparse, "bf16": launches_bf},
          "max_node_subspace_err_vs_dense": float(per_node.max()),
          "bf16_vs_f32_max_node_err": float(
              subspace_error(sparse_res.q_nodes, bf_res.q_nodes).max())})

    for name in rows:
        check(rows[name]["launches"] > 0,
              f"{name} was not launched on the main path")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": list(rows.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
