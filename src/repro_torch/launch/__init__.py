"""Operational entry points: ``psa_sweep`` (stream, then a sharded,
supervised Monte-Carlo sweep)."""
