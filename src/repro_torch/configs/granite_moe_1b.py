"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

Fine-grained MoE decoder: 24L, d_model 1024, 16 heads (GQA kv=8,
head_dim 64), 32 experts top-8 with per-expert SwiGLU d_ff 512,
vocab 49155.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    activation="swiglu",
    num_experts=32,
    num_experts_per_tok=8,
    moe_dff=512,
    rope_theta=10_000.0,
)
