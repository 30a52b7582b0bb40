"""Hymba-1.5B [arXiv:2411.13676; hf] — hybrid parallel attention+Mamba heads.

32L, d_model 1600, 25 attn heads (GQA kv=5, head_dim 64), SwiGLU d_ff
5504, vocab 32001, SSM state 16.  Sliding-window attention (1024) in all
but 3 full-attention layers {first, middle, last}; 128 learned meta
tokens prepended.  Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    activation="swiglu",
    attn_window=1024,
    global_attn_layers=(0, 15, 31),
    num_meta_tokens=128,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    rope_theta=10_000.0,
)
