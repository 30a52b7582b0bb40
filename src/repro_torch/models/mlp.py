"""Dense MLP (SwiGLU/GeGLU/ReLU^2/GELU) + sorted-capacity Mixture-of-Experts
(port of ``repro.models.mlp``).

MoE design (dbrx 16e/top-4, granite 32e/top-8): tokens are routed top-k,
sorted by expert id, gathered into per-expert capacity buffers, processed
by a batched (E, C, d) x (E, d, ff) einsum -- a grouped GEMM -- and
scattered back weighted by router probs.  Static shapes throughout
(capacity drop, GShard-style); dropped tokens fall back to the residual
stream.  Serving (``train=False``) takes the dispatch-free dense path.

The token->expert dispatch is itself a sparse mode-contraction, and the
adaptive rule of the paper (partition *indices* when plentiful, partition
*nonzeros* + reduce when not) is mirrored here: experts (few) are the
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


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_specs(cfg) -> dict:
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_dff
    return {
        "router": PSpec((d, E), ("fsdp", None), dtype=torch.float32),
        "wi": PSpec((E, d, ff), ("experts", "fsdp", "tensor")),
        "wg": PSpec((E, d, ff), ("experts", "fsdp", "tensor")),
        "wo": PSpec((E, ff, d), ("experts", "tensor", "fsdp")),
    }


def _route(cfg, p, x):
    """Router probabilities (B, S, E), the top-k gates renormalized and
    their expert ids (B, S, k), and the GShard load-balance loss: mean
    probability per expert times the fraction routed to it."""
    B, S, _ = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gate, expert = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, expert.reshape(-1), torch.ones(expert.numel(), device=x.device)) / (B * S * k)
    return probs, gate, expert, E * torch.sum(me * ce)


def moe_apply(cfg, p, x, *, train=True):
    """x: (B, S, d) -> (B, S, d), plus the load-balance aux loss (a float32
    scalar tensor).

    Dispatch is PER BATCH ROW (group = sequence): sort, capacity and
    gather/scatter all act on (B, S*k).  ``train=False`` (eval/serving)
    takes the dispatch-free dense path: capacity dropping depends on the
    surrounding sequence (which tokens share an expert), so a
    capacity-dropped token would decode differently than it forwards --
    inference must be drop-free for decode/forward parity.
    """
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok

    if not train or cfg.moe_dense_eval:
        return _moe_dense_eval(cfg, p, x)

    _, gate, expert, aux = _route(cfg, p, x)

    # Per-row capacity (GShard-style dropping keeps shapes static).
    C = int(cfg.capacity_factor * S * k / E)
    C = max(8, -(-C // 8) * 8)

    fe = expert.reshape(B, S * k)                              # (B, S*k)
    ft = torch.arange(S, device=x.device).repeat_interleave(k).expand(B, S * k)
    fg = gate.reshape(B, S * k)
    order = torch.argsort(fe, dim=1, stable=True)
    se = torch.gather(fe, 1, order)
    st = torch.gather(ft, 1, order)
    sg = torch.gather(fg, 1, order)
    seg_pos = _segment_positions(se)
    keep = seg_pos < C
    slot = torch.where(keep, se * C + seg_pos, E * C)         # drop -> E*C

    # Gather tokens into per-row (E*C, d) buffers (extra row absorbs drops;
    # which of its writes lands there does not matter, the row is cut off).
    rows = torch.arange(B, device=x.device)[:, None]
    xs = torch.gather(x, 1, st[..., None].expand(B, S * k, d))
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[rows, slot] = xs
    xe = buf[:, : E * C].reshape(B, E, C, d)

    h = torch.einsum("becd,edf->becf", xe, p["wi"])
    g = torch.einsum("becd,edf->becf", xe, p["wg"])
    h = F.silu(g) * h
    ye = torch.einsum("becf,efd->becd", h, p["wo"])            # (B, E, C, d)

    # Scatter back, weighted by gate prob.
    yf = ye.reshape(B, E * C, d)
    contrib = torch.where(keep, sg, 0.0)[..., None].to(x.dtype)
    safe_slot = torch.clamp(slot, max=E * C - 1)
    gathered = torch.gather(yf, 1, safe_slot[..., None].expand(B, S * k, d))
    y = torch.zeros((B, S, d), dtype=x.dtype, device=x.device).scatter_add_(
        1, st[..., None].expand(B, S * k, d), gathered * contrib)
    return y, aux


def _moe_dense_eval(cfg, p, x):
    """Dispatch-free MoE: every expert processes every token; top-k gate
    weights zero out the rest.  With tiny per-expert d_ff (granite: 512)
    the sort + scatter + capacity-buffer traffic of real dispatch exceeds
    the cost of computing all experts (E/k more FLOPs) when the step is
    memory-bound.  No tokens are dropped."""
    probs, gate, expert, aux = _route(cfg, p, x)
    w = torch.zeros_like(probs).scatter_(-1, expert, gate)    # (B, S, E)
    h = torch.einsum("bsd,edf->ebsf", x, p["wi"])
    g = torch.einsum("bsd,edf->ebsf", x, p["wg"])
    h = F.silu(g) * h
    h = h * w.permute(2, 0, 1)[..., None].to(h.dtype)
    y = torch.einsum("ebsf,efd->bsd", h, p["wo"])
    return y, aux


def _segment_positions(sorted_ids):
    """Rank of each element within its (sorted) segment along the last
    axis: [0,0,1,2,0,1,...]."""
    n = sorted_ids.shape[-1]
    idx = torch.arange(n, device=sorted_ids.device).expand_as(sorted_ids)
    # index of segment start for each element
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[..., 1:] = sorted_ids[..., 1:] != sorted_ids[..., :-1]
    start_idx = torch.where(is_start, idx, 0)
    return idx - torch.cummax(start_idx, dim=-1).values
