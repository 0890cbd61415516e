"""The port's algorithms: topology, consensus, linear algebra, S-DOT, and
gossip across processes (``SpmdConsensus``, ``two_level_reduce``,
``sdot_spmd``)."""
from .consensus import SpmdConsensus, two_level_reduce  # noqa: F401
from .sdot import sdot_spmd  # noqa: F401
