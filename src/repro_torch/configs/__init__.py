"""Architecture registry: --arch <id> resolves here.

The twin of ``repro/configs/__init__.py``, over the port's own copies of
the config files. ``models.transformer`` builds every architecture of it.
"""
from __future__ import annotations

import importlib
from typing import Dict

from .base import SHAPES, ModelConfig, PSAConfig, ShapeConfig  # noqa: F401

_ARCH_MODULES = {
    "xlstm-1.3b": "xlstm_1_3b",
    "internlm2-20b": "internlm2_20b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "command-r-35b": "command_r_35b",
    "qwen2-7b": "qwen2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "paligemma-3b": "paligemma_3b",
    "musicgen-medium": "musicgen_medium",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; one of {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def get_shape(shape_id: str) -> ShapeConfig:
    return SHAPES[shape_id]


def get_psa_config() -> PSAConfig:
    mod = importlib.import_module(".paper_psa", __package__)
    return mod.CONFIG


def valid_cells():
    """All 40 (arch, shape) cells with their run/skip status.

    long_500k is skipped for pure full-attention archs (needs sub-quadratic
    token mixing — see DESIGN.md §Arch-applicability); a skip is recorded,
    not silently dropped.
    """
    cells = []
    for aid in ARCH_IDS:
        cfg = get_arch(aid)
        for sid, shp in SHAPES.items():
            skip = (sid == "long_500k" and not cfg.subquadratic)
            reason = "full-attention arch: 500k decode cache infeasible" if skip else ""
            cells.append({"arch": aid, "shape": sid, "skip": skip, "reason": reason})
    return cells


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    import dataclasses
    small = dict(
        n_layers=len(cfg.block_pattern),
        d_model=64,
        n_heads=max(2, min(cfg.n_heads, 4)),
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128 if cfg.d_ff > 0 else 0,
        vocab_size=256,
        head_dim=16 if cfg.head_dim is not None else None,
        window=min(cfg.window, 32) if cfg.window else None,
        mlstm_chunk=16,
        n_prefix_tokens=4 if cfg.n_prefix_tokens else 0,
        dtype="float32",
    )
    if cfg.moe is not None:
        import dataclasses as dc
        small["moe"] = dc.replace(cfg.moe, n_experts=4, top_k=2, d_expert=64,
                                  n_shared_experts=min(cfg.moe.n_shared_experts, 1))
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
