"""B-DOT, block-partitioned distributed PSA, in the PyTorch port; the twin
of examples/block_partitioned_bdot.py.

Data partitioned by both samples and features: a 4 x 5 grid of nodes, each
holding one (d/4 x n/5) block, estimates the global top-r eigenspace with
only block-local payloads (n_j x r column partials, d_i x r row partials,
r x r QR Grams).

    PYTHONPATH=src python -m repro_torch.block_partitioned_bdot     # card
    PYTHONPATH=src python -m repro_torch.block_partitioned_bdot --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from ._device import resolve_device
from .core.bdot import bdot
from .core.consensus import DenseConsensus
from .core.linalg import eigh_topr
from .core.topology import erdos_renyi
from .data.pipeline import (gaussian_eigengap_data, partition_features,
                            partition_samples)

D, N, R, I, J = 40, 4000, 5, 4, 5


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    dev = resolve_device(ap.parse_args(argv).device)

    x, _, _ = gaussian_eigengap_data(D, N, R, 0.6, seed=0, device=dev)
    _, q_true = eigh_topr(x @ x.T, R)
    blocks = [partition_samples(sl, J) for sl in partition_features(x, I)]
    print(f"{I}x{J} grid; block at node (i,j): "
          f"{tuple(blocks[0][0].shape)} of the global {tuple(x.shape)}")

    cols = [DenseConsensus(erdos_renyi(I, 0.7, seed=j), device=dev)
            for j in range(J)]
    rows = [DenseConsensus(erdos_renyi(J, 0.7, seed=10 + i), device=dev)
            for i in range(I)]
    res = bdot(blocks=blocks, col_engines=cols, row_engines=rows, r=R,
               t_outer=60, t_c=50, q_true=q_true, device=dev)

    q = res.q_full
    ortho = float((q.T @ q - torch.eye(R, device=dev)).abs().max())
    print(f"final subspace error: {res.error_trace[-1]:.2e}")
    print(f"orthonormality |Q^T Q - I|_max: {ortho:.2e}")
    print(f"largest single message: {max(N // J, D // I) * R} elems "
          f"(vs S-DOT {D * R}, F-DOT {N * R})")
    assert res.error_trace[-1] < 1e-4
    print("OK")
    return {"final_err": float(res.error_trace[-1]), "ortho": ortho}


if __name__ == "__main__":
    main()
