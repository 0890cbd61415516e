"""qwen2-7b — GQA with QKV bias [arXiv:2407.10671; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18_944, vocab_size=152_064,
    block_pattern=("attn",), qkv_bias=True, rope_theta=1e6,
)
