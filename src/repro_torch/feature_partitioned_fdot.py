"""F-DOT, feature-wise partitioned PSA (the paper's Alg. 2), in the PyTorch
port; the twin of examples/feature_partitioned_fdot.py.

A sensor-array setting: each of 10 nodes observes 2 of the 20 features of a
common signal. Together they estimate the top-4 principal subspace of the
global covariance; each node only ever learns its own rows of the basis.

    PYTHONPATH=src python -m repro_torch.feature_partitioned_fdot   # card
    PYTHONPATH=src python -m repro_torch.feature_partitioned_fdot --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from ._device import resolve_device
from .core.consensus import DenseConsensus
from .core.fdot import fdot
from .core.linalg import eigh_topr
from .core.topology import erdos_renyi
from .data.pipeline import gaussian_eigengap_data, partition_features

D, R, N_NODES, N_SAMPLES = 20, 4, 10, 4000


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    dev = resolve_device(ap.parse_args(argv).device)

    x, _, _ = gaussian_eigengap_data(D, N_SAMPLES, R, 0.6, seed=0,
                                     device=dev)
    _, q_true = eigh_topr(x @ x.T, R)
    blocks = partition_features(x, N_NODES)
    print(f"{N_NODES} nodes, {blocks[0].shape[0]} features each, "
          f"{N_SAMPLES} shared samples")

    engine = DenseConsensus(erdos_renyi(N_NODES, p=0.5, seed=1), device=dev)
    res = fdot(data_blocks=blocks, engine=engine, r=R, t_outer=80, t_c=50,
               q_true=q_true, device=dev)

    q = res.q_full
    ortho = float((q.T @ q - torch.eye(R, device=dev)).abs().max())
    print(f"final subspace error: {res.error_trace[-1]:.2e}")
    print(f"orthonormality |Q^T Q - I|_max: {ortho:.2e}")
    print(f"P2P per node: {res.ledger.per_node_p2p(N_NODES)/1e3:.1f}K "
          f"(consensus payloads: n x r partials + r x r Grams only)")
    assert res.error_trace[-1] < 1e-4
    print("OK")
    return {"final_err": float(res.error_trace[-1]), "ortho": ortho,
            "p2p_per_node": res.ledger.per_node_p2p(N_NODES)}


if __name__ == "__main__":
    main()
