"""Architecture config registry (port of ``repro.configs``):
``get_config("<arch-id>")`` for all ten archs and ``reduce_config``.  The
configs are data, so every arch is here, also those whose model family
the port does not run yet (``repro_torch.models.get_model`` says which).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.base import SHAPES, ModelConfig, ShapeCfg

_ARCH_MODULES = {
    "minitron-4b": "minitron_4b",
    "qwen1.5-4b": "qwen1_5_4b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen1.5-32b": "qwen1_5_32b",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-large-v3": "whisper_large_v3",
    "dbrx-132b": "dbrx_132b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "mamba2-780m": "mamba2_780m",
    "internvl2-1b": "internvl2_1b",
}

ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; options: {list(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a full config to a CPU-smoke-testable sibling of the same
    family: few layers, narrow width, tiny vocab — same code paths."""
    heads = max(2, min(cfg.num_heads, 4)) if cfg.num_heads else 0
    kvh = max(1, min(cfg.num_kv_heads, 2)) if cfg.num_kv_heads else 0
    if heads and kvh:
        heads = (heads // kvh) * kvh  # keep divisible
    hd = 16 if cfg.head_dim else 0
    d = max(32, heads * hd) if heads else 64
    small = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.family == "hybrid" else 2),
        d_model=d,
        num_heads=heads,
        num_kv_heads=kvh,
        head_dim=hd,
        d_ff=min(cfg.d_ff, 4 * d) if cfg.d_ff else 0,
        vocab_size=512,
        dtype="float32",
        remat="none",
        attn_chunk=32,
        vocab_round=64,
    )
    if cfg.num_experts:
        small.update(num_experts=min(cfg.num_experts, 4),
                     num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
                     moe_dff=32)
    if cfg.ssm_state:
        small.update(ssm_state=min(cfg.ssm_state, 16), ssm_head_dim=16,
                     ssm_ngroups=1, ssm_chunk=16, ssm_expand=2)
    if cfg.family == "hybrid":
        small.update(attn_window=16, num_meta_tokens=4,
                     global_attn_layers=(0, 3))
    if cfg.enc_layers:
        small.update(enc_layers=2, enc_seq=24)
    if cfg.num_prefix_tokens:
        small.update(num_prefix_tokens=8)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


__all__ = ["ARCHS", "SHAPES", "ShapeCfg", "get_config", "reduce_config"]
