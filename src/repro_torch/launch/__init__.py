"""Operational entry points: ``psa_sweep`` (stream, then a sharded,
supervised Monte-Carlo sweep), ``train`` (the training driver) and
``mesh`` (process groups and the rank spawner) and ``analytic_cost`` (the
per-step FLOP / byte model of every architecture and shape)."""
