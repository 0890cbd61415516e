"""PSA gradient compression, the paper's S-DOT doing real work in training:
the twin of ``repro/optim/psa_compress.py``.

Each pod is one node of the paper's network, one rank of the pod axis
(``launch/mesh.AxisGroup``). Per optimizer step, the cross-pod reduction of
a weight gradient G in R^{a x b} all-reduces the projected U = P^T G in
R^{r x b} instead of G (traffic / (a / r)); the projector P spans the
principal subspace of recent gradients. P itself is kept by distributed
orthogonal iteration with inter-pod consensus, S-DOT verbatim: the local
second moment M_pod = G G^T applied gram-free (Z = G (G^T P)), gossip rounds
over the pod ring, and a QR whose Grams go through the Hopper kernel
(``kernels/ops.gram_qr``, one launch for a stacked leaf's groups): shifted
CholeskyQR3 where the reference takes one CholeskyQR pass, which breaks
down in f32 on ill-conditioned gradients (``_cholesky_qr``).
Theorem 1 is what licenses inexact consensus: a bounded subspace mismatch
across pods perturbs only the compressor, and error feedback recycles what
the projector misses into the next step.

Compression targets leaves with trailing dims (a, b), a >= 4r, b >= r;
leading dims (the layer-group stack) share one projector per group.
Everything else, and the embedding table, is reduced uncompressed (f32).
State trees are nested dicts with ``None`` at the leaves that are not
compressed.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import _tree
from ..configs.base import PSAConfig
from ..kernels import ops as kops

__all__ = ["psa_init", "compress_grads", "psa_refresh", "compressible",
           "compression_ratio", "group_mean", "CQR_PASSES"]


def compressible(leaf: torch.Tensor, rank: int) -> bool:
    return (leaf.dim() >= 2 and leaf.shape[-2] >= 4 * rank
            and leaf.shape[-1] >= rank)


def _proj_shape(leaf: torch.Tensor, rank: int):
    a = leaf.shape[-2]
    if leaf.dim() >= 3:          # stacked groups: one projector per group
        return (leaf.shape[0], a, rank)
    return (a, rank)


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts; ``None`` is a leaf."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def psa_init(params, cfg: PSAConfig, seed: int = 0,
             proj: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Projectors (orthonormal) and error-feedback buffers.

    Projectors are drawn leaf by leaf, in the reference's leaf order, from
    a CPU generator seeded by ``seed`` (the same bits on every rank), then
    moved to the leaf's device. ``proj`` (a tree of arrays or tensors with
    ``None`` where nothing is compressed) replaces the draw: the parity
    tests pass the reference's own projectors. A leaf whose path has a
    component ``embed`` is not compressed: its gradient is reduced densely
    (train/step.py). Meta-device parameters give meta state and draw
    nothing (``launch/dryrun.py``).
    """
    names, leaves, structure = _tree.flatten_with_names(params)
    gen = torch.Generator().manual_seed(seed)
    given = None if proj is None else dict(
        zip(*_tree.flatten_with_names(proj)[:2]))

    def eligible(name, leaf):
        return compressible(leaf, cfg.rank) and "embed" not in name.split("/")

    projs, efs = [], []
    for name, leaf in zip(names, leaves):
        if not eligible(name, leaf):
            projs.append(None)
            efs.append(None)
            continue
        if leaf.device.type == "meta":  # shapes only (launch/dryrun.py)
            projs.append(torch.empty(_proj_shape(leaf, cfg.rank),
                                     device="meta"))
            efs.append(torch.empty(leaf.shape, device="meta"))
            continue
        if given is None:
            q = torch.randn(_proj_shape(leaf, cfg.rank), generator=gen,
                            dtype=torch.float32)
            q = torch.linalg.qr(q)[0]
        else:
            q = given[name]
            if not isinstance(q, torch.Tensor):
                q = torch.from_numpy(np.array(q, np.float32))
        projs.append(q.to(leaf.device, torch.float32))
        efs.append(torch.zeros(leaf.shape, dtype=torch.float32,
                               device=leaf.device))
    return {"proj": _tree.unflatten(structure, projs),
            "ef": _tree.unflatten(structure, efs)}


def _bcast_proj(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A (G?, a, r) projector broadcast over the extra leading dims of g."""
    if p.dim() == 2:
        extra = g.dim() - 2
        return p.reshape((1,) * extra + p.shape) if extra else p
    mid = g.dim() - 3                      # p: (G, a, r); g: (G, ..., a, b)
    return p.reshape(p.shape[:1] + (1,) * mid + p.shape[1:]) if mid else p


def group_mean(g: torch.Tensor, group, *,
               donate: bool = False) -> torch.Tensor:
    """``g``'s mean over the ranks of ``group`` (an ``AxisGroup``): an f32
    all-reduce divided by the group's size, in ``g``'s dtype. ``donate``
    writes the mean into ``g``."""
    out = (group.all_reduce_(g.to(torch.float32, copy=True))
           / group.size).to(g.dtype)
    return g.copy_(out) if donate else out


def compress_grads(grads, psa_state, cfg: PSAConfig, *, pod_axis=None,
                   donate: bool = False):
    """This pod's gradients -> the pod mean, compressed across pods.

    ``pod_axis``: the ``AxisGroup`` of the pods, or ``None`` (one pod: the
    projection and error feedback still run, the reduction is the
    identity). Returns (reduced_grads, new_ef). An uncompressed leaf is an
    f32 all-reduce divided by the number of pods; a compressed one reduces
    only U = P^T (G + e). ``donate=True`` writes each reduced gradient into
    its gradient tensor and each new error into its old buffer.
    """
    npods = pod_axis.size if pod_axis is not None else 1

    def one(g, p, e):
        if p is None:
            if pod_axis is None:
                return g, None
            return group_mean(g, pod_axis, donate=donate), None
        g32 = g.to(torch.float32, copy=True)
        if cfg.error_feedback and e is not None:
            g32 += e
        pb = _bcast_proj(p, g32)
        u_local = pb.mT @ g32                            # compress
        u = u_local
        if pod_axis is not None:                         # r x b traffic only
            u = pod_axis.all_reduce_(u_local.clone()) / npods
        ghat = (pb @ u).to(g.dtype)                      # decompress
        new_e = None
        if cfg.error_feedback:
            resid = pb @ u_local
            new_e = (torch.sub(g32, resid, out=e) if donate and e is not None
                     else g32 - resid)
        if donate:
            ghat = g.copy_(ghat)
        return ghat, new_e

    out = _map(one, grads, psa_state["proj"], psa_state["ef"])
    red = _map(lambda t: t[0], out)
    ef = _map(lambda t: t[1], out)
    return red, ef


def _ring_gossip(z: torch.Tensor, pod_axis, rounds: int,
                 n: int) -> torch.Tensor:
    """S-DOT's inner loop over the pods: ring gossip with local-degree
    weights, w_self = w_prev = w_next = 1/3 (n > 2); two pods average
    exactly in one round, whatever ``rounds`` is."""
    if n == 1:
        return z
    i = pod_axis.index
    if n == 2:
        for _ in range(min(rounds, 1)):
            z = 0.5 * z + 0.5 * pod_axis.exchange(z, [1 - i])[0]
        return z
    for _ in range(rounds):
        z_prev, z_next = pod_axis.exchange(z, [(i - 1) % n, (i + 1) % n])
        z = (z + z_prev + z_next) / 3.0
    return z


CQR_PASSES = 3     # Gram launches of one ``_cholesky_qr``
_UNIT = torch.finfo(torch.float32).eps / 2      # f32 unit roundoff


def _cqr_pass(v: torch.Tensor, gram: torch.Tensor) -> torch.Tensor:
    """One CholeskyQR pass on ``gram`` + 1e-12 I, the reference's ridge
    (which keeps a zero gradient's Q at 0). A matrix whose Cholesky breaks
    down there (V rank-deficient in f32: a direction the last projector
    lost) takes a ridge of r a u max_i G_ii instead, above the Gram's
    rounding: its Q stays bounded, with ~0 in the lost directions, where the
    plain pass returns NaN. No host sync: both factors are taken, and the
    ridged one kept only where the plain one failed."""
    a, r = v.shape[-2:]
    eye = torch.eye(r, device=gram.device)
    low, info = torch.linalg.cholesky_ex(gram + 1e-12 * eye)
    ridge = r * a * _UNIT * gram.diagonal(dim1=-2, dim2=-1).amax(-1)
    safe = torch.linalg.cholesky_ex(
        gram + (ridge[..., None, None] + 1e-12) * eye).L
    low = torch.where((info > 0)[..., None, None], safe, low)
    return torch.linalg.solve_triangular(low.mT, v, upper=True, left=False)


def _cholesky_qr(v: torch.Tensor) -> torch.Tensor:
    """Q of V = Q R (R with a positive diagonal), every Gram through the
    Gram kernel (one launch for a (G, a, r) stack): shifted CholeskyQR3
    (Fukaya et al., SIAM J. Sci. Comput. 2020), a pass on V^T V + s I with
    s = 11 (a r + r (r + 1)) u ||V||_F^2, then two plain passes.

    The reference takes one pass on V^T V + 1e-12 I. In f32 that Q is off
    orthonormal by ~kappa(V)^2 u, and from kappa ~1e4 it is no projector at
    all (entries of 1e6 and more): a gradient dominated by a few directions
    gets there, and the example at ``--full-100m`` did at its step-32
    refresh on the H100, its loss non-finite one step later (PERF.md). Where one pass is sound, this is the same Q to that pass's
    rounding. A V that is rank-deficient in f32 gets a bounded Q with ~0
    columns in its missing directions (``_cqr_pass``), never NaN.
    """
    a, r = v.shape[-2:]
    gram = kops.gram_qr(v)
    shift = 11 * (a * r + r * (r + 1)) * _UNIT * gram.diagonal(
        dim1=-2, dim2=-1).sum(-1)
    q = _cqr_pass(v, gram + shift[..., None, None]
                  * torch.eye(r, device=v.device))
    for _ in range(CQR_PASSES - 1):
        q = _cqr_pass(q, kops.gram_qr(q))
    return q


def psa_refresh(grads, psa_state, cfg: PSAConfig, *, pod_axis=None):
    """S-DOT subspace refresh: ``oi_iters`` orthogonal iterations, each
    with ``gossip_rounds`` rounds of consensus over the pods and a gram-free
    local apply."""
    npods = pod_axis.size if pod_axis is not None else 1

    def one(g, p):
        if p is None:
            return None
        g32 = g.to(torch.float32)
        q = p
        for _ in range(cfg.oi_iters):
            qb = _bcast_proj(q, g32)
            s = qb.mT @ g32                                  # (.., r, b)
            z = g32 @ s.mT                                   # local M_pod q
            if z.dim() > q.dim():        # shared projector per group
                axes = (tuple(range(1, z.dim() - 2)) if q.dim() == 3
                        else tuple(range(0, z.dim() - 2)))
                z = z.sum(dim=axes)
            if pod_axis is not None:
                z = _ring_gossip(z, pod_axis, cfg.gossip_rounds, npods)
            q = _cholesky_qr(z)
        return q

    return {"proj": _map(one, grads, psa_state["proj"]),
            "ef": psa_state["ef"]}


def compression_ratio(params, cfg: PSAConfig) -> float:
    """Analytic cross-pod traffic ratio (compressed / dense), as the
    reference counts it: every compressible leaf, the embedding included."""
    dense = comp = 0
    for leaf in _tree.tree_leaves(params):
        n = leaf.numel()
        dense += n
        comp += n // leaf.shape[-2] * cfg.rank \
            if compressible(leaf, cfg.rank) else n
    return comp / dense
