"""The paper's own workload: distributed PSA over sample-partitioned data.

Not an LM architecture — this config parameterizes the S-DOT/SA-DOT runs and
the PSA-compression feature of the training stack.
"""
from .base import PSAConfig

CONFIG = PSAConfig(enabled=True, rank=64, refresh_every=32,
                   oi_iters=2, gossip_rounds=4, error_feedback=True)
