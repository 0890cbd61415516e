"""AdamW and the PSA gradient compression of the training step."""
from .adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .psa_compress import (compress_grads, compression_ratio,  # noqa: F401
                           psa_init, psa_refresh)
