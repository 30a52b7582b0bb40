"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder audio backbone.

32 encoder + 32 decoder layers, d_model 1280, 20 heads (MHA, head_dim
64), GELU d_ff 5120, vocab 51866, sinusoidal positions, LayerNorm.
Conv frontend is a STUB per the assignment: input_specs supplies
precomputed mel-frame embeddings (B, 1500, 1280).
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-large-v3",
    family="encdec",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    activation="gelu",
    norm="layernorm",
    pos_embedding="sinusoidal",
    enc_layers=32,
    enc_seq=1500,
)
