"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B; config family verified via Qwen1.5-0.5B].

Dense decoder with QKV bias: 40L, d_model 2560, 20 heads (MHA: kv=20,
head_dim 128), SwiGLU d_ff 6912, vocab 151936.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151_936,
    qkv_bias=True,
    activation="swiglu",
    rope_theta=1_000_000.0,
)
