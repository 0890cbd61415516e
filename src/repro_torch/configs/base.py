"""Config schema for every selectable architecture and input shape.

The twin of ``repro/configs/base.py``: the same dataclasses and fields.
``torch_dtype`` stands for the reference's ``jnp_dtype``, and
``param_count()`` counts the port's own ``init_params`` on the ``meta``
device, where the reference runs ``jax.eval_shape``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

__all__ = ["MoEConfig", "ModelConfig", "ShapeConfig", "SHAPES", "PSAConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN width
    n_shared_experts: int = 0     # dense experts always active (Kimi-style)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # block pattern, cycled to n_layers. entries:
    #   attn   full causal attention
    #   swa    sliding-window attention (needs window)
    #   mlstm  xLSTM matrix-memory block (chunked linear attention)
    #   slstm  xLSTM scalar-memory block (sequential scan)
    #   rglru  RecurrentGemma gated linear recurrence
    block_pattern: Tuple[str, ...] = ("attn",)
    window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    qkv_bias: bool = False
    attn_out_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    frontend: Optional[str] = None      # None | "vlm_patches" | "audio_codec"
    n_codebooks: int = 1                # audio frontend
    n_prefix_tokens: int = 0            # vlm frontend: image patch tokens
    mlstm_chunk: int = 256              # chunk length for mLSTM linear attn
    dtype: str = "bfloat16"
    # which shapes are valid (long_500k only for sub-quadratic token mixing)
    subquadratic: bool = False
    # int8 KV cache (per-token/head absmax scale) — halves decode cache
    # capacity and read traffic vs bf16 (serving optimization, §Perf)
    kv_quant: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def pattern_for_layers(self) -> Tuple[str, ...]:
        p = self.block_pattern
        assert self.n_layers % len(p) == 0, (
            f"{self.name}: n_layers {self.n_layers} not a multiple of pattern {p}")
        return p

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.block_pattern)

    def param_count(self) -> int:
        """Exact parameter count (the real init on the meta device, cached)."""
        return _exact_param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per_blk_all = (m.n_experts + m.n_shared_experts) * 3 * self.d_model * m.d_expert
        per_blk_act = (m.top_k + m.n_shared_experts) * 3 * self.d_model * m.d_expert
        n_moe_blocks = self.n_groups * sum(
            1 for b in self.pattern_for_layers() if b in ("attn", "swa"))
        return self.param_count() - n_moe_blocks * (per_blk_all - per_blk_act)

    def _block_params(self, blk: str) -> int:
        d, hd = self.d_model, self.hd
        n_q, n_kv = self.n_heads, self.n_kv_heads
        per = 2 * d
        if blk in ("attn", "swa"):
            per += d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
            if self.moe is not None:
                m = self.moe
                per += d * m.n_experts
                per += (m.n_experts + m.n_shared_experts) * 3 * d * m.d_expert
            elif self.d_ff > 0:
                per += 3 * d * self.d_ff
        elif blk == "mlstm":
            up = 2 * d
            per += d * 2 * up + up * d + 3 * up
        elif blk == "slstm":
            per += 4 * d * d + d * (4 * d) // 3 * 2
        elif blk == "rglru":
            per += 2 * d * d + 2 * d
            if self.d_ff > 0:
                per += 3 * d * self.d_ff
        return per


@functools.lru_cache(maxsize=None)
def _exact_param_count(cfg: "ModelConfig") -> int:
    from ..models.transformer import init_params, tree_leaves

    params = init_params(None, cfg, device="meta")
    return sum(leaf.numel() for leaf in tree_leaves(params))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class PSAConfig:
    """Config for the paper's technique used as gradient compression."""
    enabled: bool = False
    rank: int = 64                # r — projected gradient rank
    refresh_every: int = 32       # steps between subspace (OI) refreshes
    oi_iters: int = 2             # distributed OI iterations per refresh
    gossip_rounds: int = 4        # cross-pod consensus rounds (S-DOT T_c)
    error_feedback: bool = True
