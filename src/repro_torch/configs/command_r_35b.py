"""command-r-35b — GQA, no-bias, 256k vocab
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22_528, vocab_size=256_000,
    block_pattern=("attn",), rope_theta=1e6,
)
