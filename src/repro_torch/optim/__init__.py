"""Optimizer substrate (port of ``repro.optim``): AdamW, schedules, and
int8 gradient compression for the cross-pod mean."""
from .adamw import AdamWConfig, apply_updates, global_norm, init_state, lr_at
from .compress import compressed_psum_leaf, cross_pod_mean, dequantize, quantize

__all__ = [
    "AdamWConfig", "apply_updates", "global_norm", "init_state", "lr_at",
    "compressed_psum_leaf", "cross_pod_mean", "dequantize", "quantize",
]
