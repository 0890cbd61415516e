"""Topology and schedule specs -> engines and budgets.

The part of ``repro/streaming/launcher.py`` the serving loop uses: a
topology or schedule travels as a small JSON spec, and graph
constructions are seed-deterministic, so a relaunched process rebuilds the
same engine. The sweep launcher itself (shards, supervision, leases) is not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .._device import DeviceLike
from ..core.consensus import DenseConsensus, consensus_schedule
from ..core.topology import complete, erdos_renyi, ring, star, torus2d

__all__ = ["build_engine", "build_schedule"]


def build_engine(topo: dict, device: DeviceLike = None) -> DenseConsensus:
    """Topology spec -> consensus engine on ``device`` (CUDA by default)."""
    kind = topo["kind"]
    if kind == "ring":
        g = ring(topo["n"])
    elif kind == "star":
        g = star(topo["n"])
    elif kind == "complete":
        g = complete(topo["n"])
    elif kind == "torus2d":
        g = torus2d(topo["rows"], topo["cols"])
    elif kind == "er":
        g = erdos_renyi(topo["n"], topo["p"], seed=topo.get("seed", 0))
    else:
        raise ValueError(f"unknown topology kind: {kind}")
    return DenseConsensus(g, device=device)


def build_schedule(sched: Optional[dict], t_outer: int,
                   t_c: int) -> np.ndarray:
    """Schedule spec -> (t_outer,) consensus budgets."""
    if sched is None:
        return consensus_schedule("const", t_outer, t_max=t_c)
    if "values" in sched:
        return np.asarray(sched["values"])[:t_outer]
    return consensus_schedule(sched["kind"], t_outer,
                              t_max=sched.get("t_max", t_c),
                              cap=sched.get("cap"))
