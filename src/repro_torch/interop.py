"""Carry a reference run's state across as NumPy arrays.

The JAX package's state for an S-DOT run is a handful of arrays: the
graph's adjacency and weights, the data blocks or the covariance stack,
``q_init`` and ``q_true``, and for a sparse engine the ELL arrays
(``ell_idx``, ``ell_val``, ``diag``, ``row_nnz``). A caller extracts them
with ``np.asarray(...)`` and hands them here, so both packages compute from
the same values. This module imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .core.consensus import DenseConsensus
from .core.sparse import SparseW
from .core.topology import Graph

__all__ = ["from_reference_arrays"]

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
    float32 tensors. Integer arrays become int32, as the reference holds
    them.
    """
    dev = resolve_device(device)
    out: dict = {}
    for key in _TENSORS:
        if key in arrays:
            out[key] = torch.as_tensor(np.array(arrays[key], np.float32),
                                       device=dev)
    if "blocks" in arrays:
        out["data"] = [torch.as_tensor(np.array(b, np.float32), device=dev)
                       for b in arrays["blocks"]]
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
