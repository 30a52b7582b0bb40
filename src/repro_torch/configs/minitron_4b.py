"""Minitron-4B — width-pruned Nemotron-4 [arXiv:2407.14679; hf].

Dense decoder: 32L, d_model 3072, 24 heads (GQA kv=8, head_dim 128),
d_ff 9216 with squared-ReLU (Nemotron family), vocab 256000.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256_000,
    activation="relu2",
    norm="rmsnorm",
    rope_theta=10_000.0,
)
