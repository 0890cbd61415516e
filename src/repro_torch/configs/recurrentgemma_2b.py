"""recurrentgemma-2b — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427; hf]. Hybrid => long_500k runs (local-attn window cache).

The HF model is 26 layers with pattern (r, r, a) x 8 + (r, r). The scan-over-
groups stack needs n_layers % len(pattern) == 0, so we use 2 groups of a
13-entry pattern — identical 1:2 recurrent:attention ratio and layer count,
with one (r, r, r) run at the group boundary (documented deviation).
"""
from .base import ModelConfig

_PATTERN_13 = ("rglru", "rglru", "swa") * 4 + ("rglru",)

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256_000,
    block_pattern=_PATTERN_13, window=2048,
    subquadratic=True,
)
