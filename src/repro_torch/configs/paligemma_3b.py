"""paligemma-3b — SigLIP + gemma backbone [arXiv:2407.07726; hf].

The SigLIP vision tower is a STUB: input_specs() supplies precomputed patch
embeddings (256 prefix positions) spliced over the text embedding prefix.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16_384, vocab_size=257_216,
    block_pattern=("attn",),
    frontend="vlm_patches", n_prefix_tokens=256,
)
