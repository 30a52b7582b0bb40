"""Dense MLP (SwiGLU/GeGLU/ReLU^2/GELU) (port of the dense half of
``repro.models.mlp``).

Still to port: the reference's sorted-capacity Mixture-of-Experts
(``moe_specs``, ``moe_apply`` and the dense-eval dispatch).  Its design
(dbrx 16e/top-4, granite 32e/top-8): tokens are routed top-k, sorted by
expert id, gathered into per-expert capacity buffers, processed by a
batched (E, C, d) x (E, d, ff) einsum -- a grouped GEMM the SPMD
partitioner can shard on the expert axis (expert parallelism) and/or the
ff axis (tensor parallelism) -- and scattered back weighted by router
probs.  Static shapes throughout (capacity drop, GShard-style); dropped
tokens fall back to the residual stream.

The token->expert dispatch is itself a sparse mode-contraction, and the
adaptive rule of the paper (partition *indices* when plentiful, partition
*nonzeros* + reduce when not) is mirrored there: experts (few) are the
"small output mode", so dispatch partitions tokens and reduces -- the
paper's scheme-2 shape.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import PSpec


def mlp_specs(cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "wi": PSpec((d, ff), ("fsdp", "tensor")),
            "wg": PSpec((d, ff), ("fsdp", "tensor")),
            "wo": PSpec((ff, d), ("tensor", "fsdp")),
        }
    return {
        "wi": PSpec((d, ff), ("fsdp", "tensor")),
        "wo": PSpec((ff, d), ("tensor", "fsdp")),
    }


def mlp_apply(cfg, p, x):
    """``jax.nn.gelu`` defaults to the tanh approximation, so GELU here is
    ``approximate="tanh"``."""
    h = x @ p["wi"]
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    elif cfg.activation == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * h
    elif cfg.activation == "relu2":   # squared ReLU (Nemotron / Minitron)
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"]
