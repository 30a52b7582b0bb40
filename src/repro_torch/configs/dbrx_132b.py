"""DBRX-base (132B total, 36B active) [hf:databricks/dbrx-base].

MoE decoder: 40L, d_model 6144, 48 heads (GQA kv=8, head_dim 128),
16 experts top-4 with per-expert SwiGLU d_ff 10752, vocab 100352.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100_352,
    activation="swiglu",
    num_experts=16,
    num_experts_per_tok=4,
    moe_dff=10752,
    rope_theta=500_000.0,
)
