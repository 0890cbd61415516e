"""Train and serve step factories."""
from .step import (loss_fn, make_psa_train_step,  # noqa: F401
                   make_serve_step, make_train_step, shard_batch)
