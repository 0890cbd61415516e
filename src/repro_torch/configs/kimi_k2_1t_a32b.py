"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8, 1 shared expert
(paper-table scale) [arXiv:2501.kimi2; unverified]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163_840, head_dim=128,
    block_pattern=("attn",),
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, n_shared_experts=1),
)
