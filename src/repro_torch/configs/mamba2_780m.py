"""Mamba2-780m [arXiv:2405.21060] — attention-free SSD decoder.

48L, d_model 1536 (d_inner 3072, 48 SSM heads of dim 64, state 128),
vocab 50280, tied embeddings.  Sub-quadratic: runs the long_500k cell
with constant-size decode state.
"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    arch="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
)
