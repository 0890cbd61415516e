"""Operational entry points: ``psa_sweep`` (stream, then a sharded,
supervised Monte-Carlo sweep), ``train`` (the training driver), ``mesh``
(process groups, the rank spawner, the wire-byte counter and the
production mesh shapes), ``analytic_cost`` (the per-step FLOP / byte model
of every architecture and shape), ``roofline`` (the H100's constants and a
cell's roofline terms) and ``dryrun`` (every cell's per-rank memory plan
on the meta device)."""
