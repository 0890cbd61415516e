"""Carry a reference run's state across as NumPy arrays.

``params_from_reference`` does the same for a decoder's parameters: the
reference's nested dict, its leaves turned into NumPy arrays.

The JAX package's state for an S-DOT, F-DOT or B-DOT run is a handful of
arrays: the graph's adjacency and weights (one graph per grid column and
per grid row for B-DOT), the data blocks, feature slabs, grid blocks or
the covariance stack, ``q_init`` and ``q_true``, and for a sparse engine
the ELL arrays (``ell_idx``, ``ell_val``, ``diag``, ``row_nnz``). A caller
extracts them with ``np.asarray(...)`` and hands them here, so both
packages compute from the same values. This module imports nothing of the
JAX package.

A run's state in flight needs no mapping: the port's ``RunState`` has the
reference's leaves in the reference's order (``0`` ... ``5``: iterate,
key, step, error trace, sends, counts) and ``checkpoint/manager.py`` reads
and writes the reference's on-disk layout. A sync S-DOT, F-DOT or B-DOT
run the reference checkpointed with ``run_chunked`` is finished by the
port's ``streaming/resume.*_chunked`` on the same directory and inputs.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .core.consensus import DenseConsensus
from .core.sparse import SparseW
from .core.topology import Graph
from .models.transformer import tree_map

__all__ = ["from_reference_arrays", "params_from_reference"]

_TENSORS = ("covs", "q_init", "q_true", "x")
_ELL = ("ell_idx", "ell_val", "diag", "row_nnz")


def from_reference_arrays(arrays: Dict[str, np.ndarray],
                          device: DeviceLike = None, *,
                          sparse: Optional[bool] = None,
                          payload_dtype: Optional[str] = None) -> dict:
    """Turn the reference's arrays into the port's objects on ``device``.

    Keys read (each optional): ``adjacency`` and ``weights`` -> ``graph``
    (a ``Graph``) and ``engine`` (a ``DenseConsensus``); ``ell_idx``,
    ``ell_val``, ``diag``, ``row_nnz`` -> ``sparse_w`` (a ``SparseW``, which
    a sparse engine then mixes through); ``covs``, ``q_init``, ``q_true``,
    ``x`` -> float32 tensors; ``blocks`` (a list) -> ``data``, a list of
    float32 tensors; ``slabs`` (a list of (d_i, n) feature slabs) ->
    ``data_blocks``; ``grid`` (a list of lists of (d_i, n_j) blocks) ->
    ``blocks``; ``col_adjacency`` / ``row_adjacency`` (lists of adjacency
    matrices) -> ``col_engines`` / ``row_engines``, a ``DenseConsensus``
    each with the reference's default local-degree weights. Integer arrays
    become int32, as the reference holds them.
    """
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    out: dict = {key: f32(arrays[key]) for key in _TENSORS if key in arrays}
    if "blocks" in arrays:
        out["data"] = [f32(b) for b in arrays["blocks"]]
    if "slabs" in arrays:
        out["data_blocks"] = [f32(b) for b in arrays["slabs"]]
    if "grid" in arrays:
        out["blocks"] = [[f32(b) for b in row] for row in arrays["grid"]]
    for key, name in (("col_adjacency", "col_engines"),
                      ("row_adjacency", "row_engines")):
        if key in arrays:
            out[name] = [DenseConsensus(
                Graph(np.asarray(a, np.float64)), sparse=sparse,
                payload_dtype=payload_dtype, device=dev) for a in arrays[key]]
    if all(k in arrays for k in _ELL):
        idx = np.asarray(arrays["ell_idx"], np.int32)
        out["sparse_w"] = SparseW(
            torch.as_tensor(idx.copy(), device=dev),
            torch.as_tensor(np.array(arrays["ell_val"], np.float32),
                            device=dev),
            torch.as_tensor(np.array(arrays["diag"], np.float32),
                            device=dev),
            torch.as_tensor(np.array(arrays["row_nnz"], np.int32),
                            device=dev),
            idx.shape[0], idx.shape[1], payload_dtype)
    if "adjacency" in arrays:
        out["graph"] = Graph(np.asarray(arrays["adjacency"], np.float64))
        weights = arrays.get("weights")
        engine = DenseConsensus(
            out["graph"],
            None if weights is None else np.asarray(weights, np.float64),
            sparse=sparse, payload_dtype=payload_dtype, device=dev)
        if engine.is_sparse and "sparse_w" in out:
            engine._w = out["sparse_w"]
        out["engine"] = engine
    return out


def params_from_reference(params: dict, device: DeviceLike = None,
                          dtype: Optional[torch.dtype] = None) -> dict:
    """The reference's decoder parameters (``jax.tree.map(np.asarray,
    params)``) as the port's: the same nested dict of tensors on ``device``.

    A bf16 leaf arrives as an ``ml_dtypes.bfloat16`` array; it goes through
    float32, which holds every bf16 value exactly, and back to
    ``torch.bfloat16``, never through its raw bytes. ``dtype`` casts every
    leaf; ``None`` keeps each leaf's own type.
    """
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return tree_map(leaf, params)
