"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0: xLSTM blocks carry their own up/down projections (mLSTM factor 2,
sLSTM gated FFN factor 4/3). mLSTM uses fixed 128-dim heads (DESIGN.md);
the pool's "4H (GQA kv=4)" is attention-family metadata with no attention
blocks present. Sub-quadratic => runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50_304,
    block_pattern=("mlstm", "slstm"),
    subquadratic=True,
)
