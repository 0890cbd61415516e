"""Quickstart: distributed PSA with S-DOT / SA-DOT (the paper's Alg. 1) in
the PyTorch port; the twin of examples/quickstart.py.

Ten nodes on an Erdos-Renyi network each hold 500 samples of 20-dim data;
every node estimates the top-5 eigenspace of the global covariance without
any raw-data exchange; the run is compared with centralized orthogonal
iteration, and the communication bill is reported.

    PYTHONPATH=src python -m repro_torch.quickstart            # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from ._device import resolve_device
from .core.consensus import DenseConsensus
from .core.linalg import eigh_topr, orthonormal_init
from .core.metrics import subspace_error
from .core.oi import orthogonal_iteration
from .core.sdot import sadot, sdot
from .core.topology import erdos_renyi
from .data.pipeline import gaussian_eigengap_data, partition_samples

D, R, N_NODES, N_PER, GAP = 20, 5, 10, 500, 0.7


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    dev = resolve_device(ap.parse_args(argv).device)

    # data, partitioned by samples across the network
    x, _, _ = gaussian_eigengap_data(D, N_NODES * N_PER, R, GAP, seed=0,
                                     device=dev)
    blocks = partition_samples(x, N_NODES)
    covs = torch.stack([b @ b.T / b.shape[1] for b in blocks])
    _, q_true = eigh_topr(covs.sum(0), R)

    # the network: ER graph, local-degree gossip weights
    graph = erdos_renyi(N_NODES, p=0.5, seed=1)
    engine = DenseConsensus(graph, device=dev)
    print(f"network: N={N_NODES} ER(p=0.5), {graph.n_edges} edges")

    # S-DOT: a fixed 50 consensus rounds per orthogonal iteration
    res = sdot(covs=covs, engine=engine, r=R, t_outer=60, t_c=50,
               q_true=q_true, device=dev)
    print(f"S-DOT : final subspace error {res.error_trace[-1]:.2e}  "
          f"P2P/node {res.ledger.per_node_p2p(N_NODES) / 1e3:.1f}K")

    # SA-DOT: the adaptive schedule (2t+1, capped at 50), fewer messages
    res_a = sadot(covs=covs, engine=engine, r=R, t_outer=60,
                  schedule_kind="lin2", cap=50, q_true=q_true, device=dev)
    print(f"SA-DOT: final subspace error {res_a.error_trace[-1]:.2e}  "
          f"P2P/node {res_a.ledger.per_node_p2p(N_NODES) / 1e3:.1f}K")

    # centralized OI (needs all the data in one place)
    q0 = orthonormal_init(torch.Generator().manual_seed(0), D, R, device=dev)
    q_oi = orthogonal_iteration(covs.sum(0), q0, 60)
    err_oi = float(subspace_error(q_true, q_oi))
    print(f"OI    : final subspace error {err_oi:.2e}  (centralized)")

    # every node agrees with every other (consensus)
    worst = max(float(subspace_error(res.q_nodes[0], res.q_nodes[i]))
                for i in range(1, N_NODES))
    print(f"worst cross-node disagreement: {worst:.2e}")
    assert res.error_trace[-1] < 1e-5
    print("OK")
    return {"sdot": float(res.error_trace[-1]),
            "sadot": float(res_a.error_trace[-1]), "oi": err_oi,
            "disagreement": worst}


if __name__ == "__main__":
    main()
