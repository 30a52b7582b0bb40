"""InternVL2-1B [arXiv:2404.16821] — InternViT-300M + Qwen2-0.5B LM.

LM backbone: 24L, d_model 896, 14 heads (GQA kv=2, head_dim 64), SwiGLU
d_ff 4864, vocab 151655, QKV bias (Qwen2).  ViT frontend is a STUB per
the assignment: input_specs supplies 256 projected patch embeddings.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    qkv_bias=True,
    activation="swiglu",
    num_prefix_tokens=256,
    rope_theta=1_000_000.0,
)
