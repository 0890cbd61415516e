"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

EnCodec frontend is a STUB: tokens arrive as (b, s, 4) codebook ids (delay
pattern applied upstream); embeddings are summed across codebooks and the
head emits 4 x 2048 logits per step.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    block_pattern=("attn",),
    frontend="audio_codec", n_codebooks=4,
)
