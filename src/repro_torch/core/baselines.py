"""Baseline algorithms the paper compares against (Figs. 4-6): the twin of
``repro/core/baselines.py``.

Centralized:
  * ``seq_pm``: sequential power method with deflation (SeqPM)
Distributed, sample-partitioned:
  * ``seq_dist_pm``: SeqPM with consensus-averaged matvecs (SeqDistPM, [13])
  * ``dsa``: distributed Sanger's algorithm (Hebbian, [19])
  * ``dpgd``: distributed projected gradient descent ([35]-style)
  * ``deepca``: gradient-tracking power iteration (DeEPCA, [27])
Distributed, feature-partitioned:
  * ``d_pm``: the sequential distributed power method of [10]

Each returns ``(q, error_trace)`` with the paper's metric (11) traced per
outer iteration (inner x outer for the consensus methods: callers scale the
x-axis).

Every distributed baseline runs fused by default: ``baseline_program``
through ``runtime.run_monolithic``, no host sync inside the loop, the
error's cross products kept on the device until the runtime takes their
SVDs, and the ledger priced in closed form. The sequential-deflation
methods (``seq_dist_pm``, ``d_pm``) step over the flattened (vector k,
inner iteration j) index; k is host data, so a step deflates against
exactly the k converged vectors, in the eager loop's Gram-Schmidt order.
``fused=False`` keeps the reference's eager loop (host debias weights, one
host sync a step) as the oracle; an engine without a debias table (an
``AsyncConsensus``) always takes it, and then logs its realized sends.

The fused bodies take any leading lane axes in front of the node axis:
``core/sweep.py`` runs them over (C, S, ...) carries with case-stacked
operands. DPGD's and DeEPCA's CholeskyQR2 goes through ``linalg``'s, so
each pass's Gram is one launch of the Hopper Gram kernel for all nodes and
lanes; ``local_cov_apply`` and d-PM's slab products stay torch ops, as the
reference's stay einsums (no Pallas kernel there).

The reference draws each init from ``jax.random.PRNGKey(seed)``; the port
draws from ``torch.Generator().manual_seed(seed)`` (or ``generator``), and
``q_init`` injects the reference's own init.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from . import runtime
from .consensus import DenseConsensus
from .linalg import cholesky_qr2, orthonormal_init
from .metrics import CommLedger, subspace_error
from .sdot import local_cov_apply
from .sparse import SparseW

__all__ = ["seq_pm", "seq_dist_pm", "dsa", "dpgd", "deepca", "d_pm",
           "baseline_program", "BaselineResult"]


def _init(d: int, r: int, *, q_init, generator, seed: int,
          device: torch.device) -> torch.Tensor:
    """Q_init: ``q_init`` if given, else a draw of ``generator`` (default:
    a CPU generator seeded with ``seed``, so the draw is the same on every
    device)."""
    if q_init is not None:
        return q_init.to(device, torch.float32)
    if generator is None:
        generator = torch.Generator().manual_seed(int(seed))
    return orthonormal_init(generator, d, r, device=device)


def _device(engine, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if engine.device != dev:
        raise ValueError(f"engine lives on {engine.device}, run asked for "
                         f"{dev}")
    return dev


def _trace(q_true, q) -> float:
    return float(subspace_error(q_true, q)) if q_true is not None else np.nan


def _masked_node_mean(q: torch.Tensor, node_mask: torch.Tensor):
    """Mean over the node axis of (..., N, d, r) restricted to
    ``node_mask > 0`` nodes (node_mask (..., N)). With a mask of ones it is
    the plain mean; a ragged sweep's mask keeps its identity-padding nodes
    out of the estimate the trace is computed from."""
    m = node_mask.to(q.dtype)[..., None, None]
    return (q * m).sum(dim=-3) / m.sum(dim=-3)


def _mix(w, z: torch.Tensor, trailing: int) -> torch.Tensor:
    """One gossip round over the node axis of z (..., N, *rest), ``rest``
    of ``trailing`` dims: a matmul with W (N, N), or (C, 1, N, N) against
    (C, S, ...) lanes; a ``SparseW`` (single runs) mixes through the ELL
    kernel."""
    if isinstance(w, SparseW):
        return w.mix(z)
    lead = z.shape[:z.dim() - trailing]
    return (w @ z.reshape(*lead, -1)).reshape(z.shape)


def _supports_fused(engine) -> bool:
    """Fused baselines need the engine's weights and its debias table;
    other engines (an ``AsyncConsensus``) take the eager loop."""
    return hasattr(engine, "_w") and hasattr(engine, "debias_table")


def _finish_errs(errs: torch.Tensor, n_steps: int,
                 trace_err: bool) -> np.ndarray:
    """The device trace on the host; NaN without a ground truth (the eager
    loop's per-iteration np.nan)."""
    return (errs.cpu().numpy().copy() if trace_err
            else np.full(n_steps, np.nan))


def _closed_form(ledger: Optional[CommLedger], rounds, engine,
                 payload: int) -> None:
    if ledger is not None:
        ledger.log_gossip_rounds(rounds, engine.graph.adjacency, payload,
                                 getattr(engine, "payload_bytes_per_elem",
                                         4.0))


@dataclasses.dataclass
class BaselineResult:
    """A fused baseline run as the runtime reports it.

    ``q`` is the family's estimate (per-node (N, d, r) for the consensus
    methods, the assembled (d, r) basis for d-PM); ``error_trace`` is
    NaN-filled without a ground truth; ``ledger`` prices the completed
    prefix in closed form (a chunked run killed mid-way reports what it
    spent)."""

    q: torch.Tensor
    error_trace: np.ndarray
    ledger: CommLedger


# --------------------------------------------------------------------------
# centralized sequential power method
# --------------------------------------------------------------------------
def seq_pm(m: torch.Tensor, r: int, iters_per_vec: int, q_true=None,
           seed: int = 0, *, q_init: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           device: DeviceLike = None):
    """Power method + deflation, one eigenvector at a time.

    The trace is taken against the full current estimate (later columns
    still at their init), the paper's observation that sequential methods
    plateau high until the last vector converges.
    """
    dev = resolve_device(device)
    m = m.to(dev, torch.float32)
    d = m.shape[0]
    q = _init(d, r, q_init=q_init, generator=generator, seed=seed,
              device=dev)
    if q_true is not None:
        q_true = q_true.to(dev, torch.float32)
    cols = [q[:, i] for i in range(r)]
    errs = []
    m_defl = m
    # deflation projector P = I - sum_j Q_j Q_j^T, one rank-1 update a
    # converged vector
    p = torch.eye(d, dtype=m.dtype, device=dev)
    for k in range(r):
        v = cols[k]
        for _ in range(iters_per_vec):
            v = m_defl @ v
            for j in range(k):     # re-orthogonalize against converged ones
                v = v - cols[j] * (cols[j] @ v)
            v = v / torch.linalg.vector_norm(v)
            errs.append(_trace(q_true, torch.stack(
                cols[:k] + [v] + cols[k + 1:], 1)))
        cols[k] = v
        p = p - torch.outer(v, v)
        m_defl = p @ m @ p
    return torch.stack(cols, dim=1), np.asarray(errs)


# --------------------------------------------------------------------------
# distributed sequential power method (SeqDistPM)
# --------------------------------------------------------------------------
def _seq_dist_pm_build_body(operands, *, r: int, iters_per_vec: int,
                            t_c: int):
    """One step of the flattened (k, j) index over the (..., r, N, d)
    per-node column estimates; the step's input is the index m."""
    covs, w, table, q_true = operands
    row = table[t_c][:, None]                                  # (N, 1)

    def body(cols, m):
        k = m // iters_per_vec
        z = (covs @ cols[..., k, :, :, None])[..., 0]          # (..., N, d)
        for _ in range(t_c):
            z = _mix(w, z, 1)
        z = z / row.to(z.dtype)
        for u in cols.unbind(-3)[:k]:          # deflate, eager order
            z = z - u * (u * z).sum(dim=-1, keepdim=True)
        v = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        cols = cols.clone()
        cols[..., k, :, :] = v
        cross = (None if q_true is None
                 else q_true.mT @ cols.mean(dim=-2).mT)        # (..., r, r)
        return cols, cross

    return runtime.sync_body(body)


def seq_dist_pm(covs: torch.Tensor, engine: DenseConsensus, r: int,
                iters_per_vec: int, t_c: int = 50, q_true=None,
                seed: int = 0, ledger: Optional[CommLedger] = None,
                fused: bool = True, *, q_init: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None):
    closed_form = _supports_fused(engine)   # sync engines: every round equal
    if fused and closed_form:
        run = runtime.run_monolithic(baseline_program(
            "seq_dist_pm", covs=covs, engine=engine, r=r,
            iters_per_vec=iters_per_vec, t_c=t_c, q_true=q_true, seed=seed,
            q_init=q_init, generator=generator, device=device))
        if ledger is not None:
            ledger.merge_from(run.ledger)
        return run.q, run.error_trace
    dev = _device(engine, device)
    covs = covs.to(dev, torch.float32)
    n, d, _ = covs.shape
    q0 = _init(d, r, q_init=q_init, generator=generator, seed=seed,
               device=dev)
    if q_true is not None:
        q_true = q_true.to(dev, torch.float32)
    cols = [q0[:, k][None].expand(n, d) for k in range(r)]
    errs = []
    done: list = []
    for k in range(r):
        v = cols[k]                                            # (n, d)
        for _ in range(iters_per_vec):
            z = (covs @ v[..., None])[..., 0]
            # async engines log realized sends a call; sync engines are
            # priced in closed form below
            z = engine.run_debiased(z, t_c, None if closed_form else ledger)
            for u in done:                 # deflate against converged ones
                z = z - u * (u * z).sum(dim=1, keepdim=True)
            v = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
            cur = [c if i != k else v for i, c in enumerate(cols)]
            qm = torch.stack([c.mean(0) for c in cur], dim=1)
            errs.append(_trace(q_true, qm))
        cols[k] = v
        done.append(v)
    if closed_form:
        _closed_form(ledger, np.full(r * iters_per_vec, t_c), engine, d)
    return torch.stack(cols, dim=2), np.asarray(errs)          # (n, d, r)


# --------------------------------------------------------------------------
# distributed Sanger's algorithm (DSA) and projected gradient (DPGD)
# --------------------------------------------------------------------------
def _sanger_step(covs, w, lr, q):
    mixed = _mix(w, q, 2)
    mq = local_cov_apply(covs, q)
    upper = torch.triu(q.mT @ mq)
    return mixed + lr * (mq - q @ upper)


def _dpgd_step(covs, w, lr, q):
    v = _mix(w, q, 2) + lr * local_cov_apply(covs, q)
    return cholesky_qr2(v)[0]                  # every node: one Gram launch


def _dsa_build_body(operands, *, name: str):
    """DSA or DPGD over (..., N, d, r) iterates."""
    covs, w, lr, q_true, node_mask = operands
    step = _sanger_step if name == "dsa" else _dpgd_step

    def body(q, _):
        q_new = step(covs, w, lr, q)
        cross = (None if q_true is None
                 else q_true.mT @ _masked_node_mean(q_new, node_mask))
        return q_new, cross

    return runtime.sync_body(body)


def _gradient_baseline(name: str, covs, engine, r, t_outer, lr, q_true,
                       seed, ledger, fused, q_init, generator, device):
    """DSA / DPGD: the fused program, or the reference's eager loop."""
    if fused and _supports_fused(engine):
        run = runtime.run_monolithic(baseline_program(
            name, covs=covs, engine=engine, r=r, t_outer=t_outer, lr=lr,
            q_true=q_true, seed=seed, q_init=q_init, generator=generator,
            device=device))
        if ledger is not None:
            ledger.merge_from(run.ledger)
        return run.q, run.error_trace
    dev = _device(engine, device)
    covs = covs.to(dev, torch.float32)
    n, d, _ = covs.shape
    q0 = _init(d, r, q_init=q_init, generator=generator, seed=seed,
               device=dev)
    if q_true is not None:
        q_true = q_true.to(dev, torch.float32)
    q = q0[None].expand(n, d, r)
    errs = []
    for _ in range(t_outer):
        mixed = engine.run(q, 1)
        mq = local_cov_apply(covs, q)
        if name == "dsa":
            upper = torch.triu(q.mT @ mq)
            q = mixed + lr * (mq - q @ upper)
        else:
            q = cholesky_qr2(mixed + lr * mq)[0]
        errs.append(_trace(q_true, q.mean(0)))
    _closed_form(ledger, np.ones(t_outer), engine, d * r)
    return q, np.asarray(errs)


def dsa(covs: torch.Tensor, engine: DenseConsensus, r: int, t_outer: int,
        lr: float = 0.1, q_true=None, seed: int = 0,
        ledger: Optional[CommLedger] = None, fused: bool = True, *,
        q_init: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None):
    """Q_i <- sum_j w_ij Q_j + lr (M_i Q_i - Q_i UT(Q_i^T M_i Q_i)).

    Converges linearly to a neighbourhood of the truth (paper Figs. 4-5);
    one gossip round an iteration, as in [19].
    """
    return _gradient_baseline("dsa", covs, engine, r, t_outer, lr, q_true,
                              seed, ledger, fused, q_init, generator, device)


def dpgd(covs: torch.Tensor, engine: DenseConsensus, r: int, t_outer: int,
         lr: float = 0.1, q_true=None, seed: int = 0,
         ledger: Optional[CommLedger] = None, fused: bool = True, *,
         q_init: Optional[torch.Tensor] = None,
         generator: Optional[torch.Generator] = None,
         device: DeviceLike = None):
    """Trace-maximisation DGD + a CholeskyQR2 retraction (converges to a
    neighbourhood)."""
    return _gradient_baseline("dpgd", covs, engine, r, t_outer, lr, q_true,
                              seed, ledger, fused, q_init, generator, device)


# --------------------------------------------------------------------------
# DeEPCA: gradient tracking + power iteration
# --------------------------------------------------------------------------
def _deepca_step(covs, w, q, s, mq_prev, t_mix):
    for _ in range(t_mix):
        s = _mix(w, s, 2)
    # sign-fixed orthonormalisation (keeps the tracking valid)
    q_new = cholesky_qr2(s)[0]
    sign = torch.sign((q_new * q).sum(dim=-2))                 # (..., N, r)
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    q_new = q_new * sign[..., None, :]
    mq_new = local_cov_apply(covs, q_new)
    return q_new, s + mq_new - mq_prev, mq_new   # gradient-tracking step


def _deepca_build_body(operands, *, t_mix: int):
    """The carry is DeEPCA's (q, s, mq_prev) tracking triple, so the
    tracking state checkpoints with the iterate."""
    covs, w, q_true, node_mask = operands

    def body(carry, _):
        q_new, s, mq_new = _deepca_step(covs, w, *carry, t_mix)
        cross = (None if q_true is None
                 else q_true.mT @ _masked_node_mean(q_new, node_mask))
        return (q_new, s, mq_new), cross

    return runtime.sync_body(body)


def deepca(covs: torch.Tensor, engine: DenseConsensus, r: int, t_outer: int,
           t_mix: int = 3, q_true=None, seed: int = 0,
           ledger: Optional[CommLedger] = None, fused: bool = True, *,
           q_init: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           device: DeviceLike = None):
    """Gradient-tracking power iteration (Ye & Zhang '21, paper ref [27]).

    s_i tracks (1/N) sum_j M_j Q_j exactly in the limit; a constant number
    of gossip rounds an outer iteration suffices.
    """
    if fused and _supports_fused(engine):
        run = runtime.run_monolithic(baseline_program(
            "deepca", covs=covs, engine=engine, r=r, t_outer=t_outer,
            t_mix=t_mix, q_true=q_true, seed=seed, q_init=q_init,
            generator=generator, device=device))
        if ledger is not None:
            ledger.merge_from(run.ledger)
        return run.q, run.error_trace
    dev = _device(engine, device)
    covs = covs.to(dev, torch.float32)
    n, d, _ = covs.shape
    q0 = _init(d, r, q_init=q_init, generator=generator, seed=seed,
               device=dev)
    if q_true is not None:
        q_true = q_true.to(dev, torch.float32)
    q = q0[None].expand(n, d, r)
    mq_prev = local_cov_apply(covs, q)
    s = mq_prev
    errs = []
    for _ in range(t_outer):
        s = engine.run(s, t_mix)
        q_new = cholesky_qr2(s)[0]
        # align signs with the previous iterate for smooth tracking
        sign = torch.sign(torch.einsum("ndr,ndr->nr", q_new, q))
        sign = torch.where(sign == 0, torch.ones_like(sign), sign)
        q_new = q_new * sign[:, None, :]
        mq_new = local_cov_apply(covs, q_new)
        s = s + mq_new - mq_prev
        mq_prev, q = mq_new, q_new
        errs.append(_trace(q_true, q.mean(0)))
    _closed_form(ledger, np.full(t_outer, t_mix), engine, d * r)
    return q, np.asarray(errs)


# --------------------------------------------------------------------------
# d-PM: sequential distributed power method, feature-partitioned data
# --------------------------------------------------------------------------
def _d_pm_build_body(operands, *, r: int, iters_per_vec: int, t_c: int):
    """One step of the flattened (k, j) index over (..., r, N, d_max) padded
    slab estimates. x_pad: (N, d_max, n) zero-padded slabs; qtrue_pad:
    (N, d_max, r_true). Dots and norms run over the padded layout, exact
    since padding entries are zero."""
    x_pad, w, table, qtrue_pad = operands
    row = table[t_c][:, None]                                  # (N, 1)

    def body(blocks, m):
        k = m // iters_per_vec
        vb = blocks[..., k, :, :]                              # (..., N, d)
        partial = (vb[..., None, :] @ x_pad)[..., 0, :]        # (..., N, n)
        for _ in range(t_c):
            partial = _mix(w, partial, 1)
        ssum = partial / row.to(partial.dtype)
        vb = (x_pad @ ssum[..., None])[..., 0]                 # (..., N, d)
        for u in blocks.unbind(-3)[:k]:
            vb = vb - u * (u * vb).sum(dim=(-2, -1), keepdim=True)
        vb = vb / torch.linalg.vector_norm(vb, dim=(-2, -1), keepdim=True)
        blocks = blocks.clone()
        blocks[..., k, :, :] = vb
        cross = (None if qtrue_pad is None else torch.einsum(
            "ids,...jid->...sj", qtrue_pad, blocks))           # (..., r, r)
        return blocks, cross

    return runtime.sync_body(body)


def d_pm(data_blocks: Sequence[torch.Tensor], engine: DenseConsensus, r: int,
         iters_per_vec: int, t_c: int = 50, q_true=None, seed: int = 0,
         ledger: Optional[CommLedger] = None, fused: bool = True, *,
         q_init: Optional[torch.Tensor] = None,
         generator: Optional[torch.Generator] = None,
         device: DeviceLike = None):
    """Scaglione et al. [10]: one eigenvector at a time, each by power
    iterations on M = X X^T executed feature-wise with consensus."""
    closed_form = _supports_fused(engine)
    if fused and closed_form:
        run = runtime.run_monolithic(baseline_program(
            "d_pm", data_blocks=data_blocks, engine=engine, r=r,
            iters_per_vec=iters_per_vec, t_c=t_c, q_true=q_true, seed=seed,
            q_init=q_init, generator=generator, device=device))
        if ledger is not None:
            ledger.merge_from(run.ledger)
        return run.q, run.error_trace
    dev = _device(engine, device)
    xs = [x.to(dev, torch.float32) for x in data_blocks]
    dims = [int(x.shape[0]) for x in xs]
    offs = np.cumsum([0] + dims)
    n_nodes = len(xs)
    q0 = _init(sum(dims), r, q_init=q_init, generator=generator, seed=seed,
               device=dev)
    if q_true is not None:
        q_true = q_true.to(dev, torch.float32)
    blocks = [[q0[offs[i]:offs[i + 1], k] for i in range(n_nodes)]
              for k in range(r)]
    errs = []
    done_full: list = []
    for k in range(r):
        vb = blocks[k]
        for _ in range(iters_per_vec):
            partial = torch.stack([x.T @ v for x, v in zip(xs, vb)])  # (N, n)
            ssum = engine.run_debiased(partial, t_c,
                                       None if closed_form else ledger)
            vb = [x @ ssum[i] for i, x in enumerate(xs)]
            vfull = torch.cat(vb)
            for u in done_full:
                vfull = vfull - u * (u @ vfull)
            vfull = vfull / torch.linalg.vector_norm(vfull)
            vb = [vfull[offs[i]:offs[i + 1]] for i in range(n_nodes)]
            cur = torch.stack([torch.cat(blocks[j]) if j != k else vfull
                               for j in range(r)], 1)
            errs.append(_trace(q_true, cur))
        blocks[k] = vb
        done_full.append(torch.cat(vb))
    if closed_form:
        _closed_form(ledger, np.full(r * iters_per_vec, t_c), engine,
                     int(xs[0].shape[1]))
    return torch.stack([torch.cat(b) for b in blocks], dim=1), np.asarray(errs)


# --------------------------------------------------------------------------
# runtime registration
# --------------------------------------------------------------------------
def baseline_program(
    name: str,
    *,
    covs: Optional[torch.Tensor] = None,
    data_blocks: Optional[Sequence[torch.Tensor]] = None,
    engine: Optional[DenseConsensus] = None,
    r: int,
    t_outer: Optional[int] = None,
    iters_per_vec: Optional[int] = None,
    lr: float = 0.1,
    t_mix: int = 3,
    t_c: int = 50,
    q_true=None,
    seed: int = 0,
    q_init: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> runtime.Program:
    """Register one fused baseline run with the runtime.

    ``name``: dsa | dpgd | deepca (``covs`` + ``t_outer``), seq_dist_pm
    (``covs`` + ``iters_per_vec``), or d_pm (``data_blocks`` +
    ``iters_per_vec``). ``runtime.run_monolithic`` gives the fused default
    of the public functions; ``runtime.run_chunked``
    (``streaming/resume.baseline_chunked``) makes every baseline
    restartable, bit for bit.
    """
    if engine is None:
        raise ValueError("baseline_program needs an engine")
    if not _supports_fused(engine):
        raise ValueError(f"fused {name} needs a dense-weight engine with a "
                         "debias table")
    dev = _device(engine, device)
    trace_err = q_true is not None
    if trace_err:
        q_true = q_true.to(dev, torch.float32)
    init = dict(q_init=q_init, generator=generator, seed=seed, device=dev)

    if name in ("dsa", "dpgd", "deepca"):
        if covs is None or t_outer is None:
            raise ValueError(f"{name} needs covs and t_outer")
        covs = covs.to(dev, torch.float32)
        n, d, _ = covs.shape
        q0 = _init(d, r, **init)[None].expand(n, d, r).contiguous()
        ones = torch.ones((n,), dtype=torch.float32, device=dev)
        xs = np.zeros(t_outer, np.int64)          # the bodies ignore it
        payload = d * r
        if name == "deepca":
            build, statics = _deepca_build_body, (("t_mix", t_mix),)
            operands = (covs, engine._w, q_true, ones)
            s0 = local_cov_apply(covs, q0)
            carry0 = (q0, s0, s0)
            rounds = lambda done: np.full(done, t_mix)  # noqa: E731
            to_q = lambda carry: carry[0]               # noqa: E731
        else:
            build, statics = _dsa_build_body, (("name", name),)
            operands = (covs, engine._w, lr, q_true, ones)
            carry0 = q0
            rounds = lambda done: np.ones(done)         # noqa: E731
            to_q = lambda carry: carry                  # noqa: E731
    elif name == "seq_dist_pm":
        if covs is None or iters_per_vec is None:
            raise ValueError("seq_dist_pm needs covs and iters_per_vec")
        covs = covs.to(dev, torch.float32)
        n, d, _ = covs.shape
        q0 = _init(d, r, **init)
        carry0 = q0.T[:, None, :].expand(r, n, d).contiguous()
        build = _seq_dist_pm_build_body
        statics = (("r", r), ("iters_per_vec", iters_per_vec), ("t_c", t_c))
        operands = (covs, engine._w, engine.debias_table(t_c), q_true)
        xs = np.arange(r * iters_per_vec, dtype=np.int64)
        payload = d
        rounds = lambda done: np.full(done, t_c)        # noqa: E731
        to_q = lambda cols: cols.permute(1, 2, 0)       # noqa: E731
    elif name == "d_pm":
        if data_blocks is None or iters_per_vec is None:
            raise ValueError("d_pm needs data_blocks and iters_per_vec")
        from .fdot import pad_feature_slabs, split_pad_rows

        dims = [int(x.shape[0]) for x in data_blocks]
        x_pad = pad_feature_slabs([x.to(dev, torch.float32)
                                   for x in data_blocks])
        q0_pad = split_pad_rows(_init(sum(dims), r, **init), dims)
        carry0 = q0_pad.permute(2, 0, 1).contiguous()       # (r, N, d_max)
        qtrue_pad = split_pad_rows(q_true, dims) if trace_err else None
        build = _d_pm_build_body
        statics = (("r", r), ("iters_per_vec", iters_per_vec), ("t_c", t_c))
        operands = (x_pad, engine._w, engine.debias_table(t_c), qtrue_pad)
        xs = np.arange(r * iters_per_vec, dtype=np.int64)
        payload = int(data_blocks[0].shape[1])               # n_samples
        rounds = lambda done: np.full(done, t_c)            # noqa: E731
        to_q = lambda blocks: torch.cat(                    # noqa: E731
            [blocks[:, i, :di].T for i, di in enumerate(dims)], dim=0)
    else:
        raise ValueError(f"unknown baseline: {name}")

    def finalize(state: runtime.RunState, done: int) -> BaselineResult:
        ledger = CommLedger()
        _closed_form(ledger, rounds(done), engine, payload)
        return BaselineResult(
            q=to_q(state.q),
            error_trace=_finish_errs(state.errs[:done], done, trace_err),
            ledger=ledger)

    return runtime.Program(build_body=build, operands=operands,
                           statics=statics, xs=xs, q0=carry0,
                           finalize=finalize)
