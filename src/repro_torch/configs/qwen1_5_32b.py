"""Qwen1.5-32B [hf:Qwen/Qwen1.5-32B; config family verified via Qwen1.5-0.5B].

Dense decoder with QKV bias: 64L, d_model 5120, 40 heads (kv=40,
head_dim 128), SwiGLU d_ff 27392, vocab 152064.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152_064,
    qkv_bias=True,
    activation="swiglu",
    rope_theta=1_000_000.0,
)
