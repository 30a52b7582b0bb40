"""Phi-4-mini (3.8B) [arXiv:2412.08905; hf].

Dense decoder: 32L, d_model 3072, 24 heads (GQA kv=8, head_dim 128),
SwiGLU d_ff 8192, vocab 200064, RoPE.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    activation="swiglu",
    rope_theta=10_000.0,
)
