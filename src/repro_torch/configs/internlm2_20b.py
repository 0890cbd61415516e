"""internlm2-20b — dense GQA [arXiv:2403.17297; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16_384, vocab_size=92_544,
    block_pattern=("attn",), rope_theta=1e6,
)
