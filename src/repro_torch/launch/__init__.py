"""Operational entry points: ``psa_sweep`` (stream, then a sharded,
supervised Monte-Carlo sweep), ``train`` (the training driver) and
``mesh`` (process groups and the rank spawner)."""
