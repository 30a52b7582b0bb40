"""Mamba-2 SSD (state-space duality) blocks [arXiv:2405.21060] (port of
``repro.models.ssm``).

Chunked SSD: the selective state-space recurrence
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t ;  y_t = C_t h_t + D x_t
is evaluated in O(S * Q) time by splitting the sequence into chunks of Q:
  * intra-chunk: a masked (Q x Q) "attention" term  C_i L_ij B_j^T x_j,
  * inter-chunk: per-chunk input states, combined by a sequential loop
    over chunks carrying the (H, N, P) state, then broadcast back.

Decode is the recurrent form: constant-size state per layer (conv window
+ (H, N, P) SSM state), so a long context costs the same per step as a
short one.

The reference computes all of this in plain ``jnp`` (no Pallas kernel),
so this module is plain PyTorch.  Every einsum the reference asks for in
float32 (``preferred_element_type``) takes float32 operands here; the
products of bfloat16 values are exact in float32.  The state is updated
in place: ``ssd_apply`` and ``ssd_decode_step`` write the new SSM state
(float32) and conv window (the activations' dtype) into the tensors of
the ``state`` they are given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import PSpec


def ssm_specs(cfg) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    H = cfg.ssm_heads
    G = cfg.ssm_ngroups
    N = cfg.ssm_state
    conv_dim = di + 2 * G * N
    return {
        # projections: [z (di), x (di), B (G*N), C (G*N), dt (H)]
        "in_proj": PSpec((d, 2 * di + 2 * G * N + H), ("fsdp", "tensor")),
        "conv_w": PSpec((cfg.conv_kernel, conv_dim), (None, "tensor")),
        "conv_b": PSpec((conv_dim,), ("tensor",), "zeros"),
        "A_log": PSpec((H,), ("tensor",), "zeros"),
        "D": PSpec((H,), ("tensor",), "zeros"),
        "dt_bias": PSpec((H,), ("tensor",), "zeros"),
        "norm_scale": PSpec((di,), (None,), "zeros"),
        "out_proj": PSpec((di, d), ("tensor", "fsdp")),
    }


def _split_proj(cfg, zxbcdt):
    di, G, N = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di: 2 * di + 2 * G * N]
    dt = zxbcdt[..., 2 * di + 2 * G * N:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d: xBC (B,S,D), w (K,D)."""
    K = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(K):
        out = out + pad[:, i: i + S] * w[i]
    return F.silu(out + b)


def _gated_rmsnorm(y, z, scale, eps=1e-6):
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.float()), -1, keepdim=True)
    return (y.float() * torch.rsqrt(var + eps)).to(y.dtype) * (
        1.0 + scale.to(y.dtype))


def _decay(x):
    """``exp`` of a log-decay, clipped to [-60, 0] first as the reference
    clips it."""
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def ssd_apply(cfg, p, x, *, state=None):
    """Train/prefill SSD.  x (B,S,d) -> (y (B,S,d), state | None).

    ``state`` (if given) is a fresh decode state (``init_ssm_state``); its
    ``ssm`` and ``conv`` tensors receive the final state in place, and it
    is returned with ``pos`` advanced by S.
    """
    B, S, d = x.shape
    di, G, N, H = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    S_p = -(-S // Q) * Q

    zxbcdt = x @ p["in_proj"]
    z, xBC_raw, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xs = xBC[..., :di]
    Bm = xBC[..., di: di + G * N].reshape(B, S, G, N)
    Cm = xBC[..., di + G * N:].reshape(B, S, G, N)

    A = -torch.exp(p["A_log"].float())                              # (H,) < 0
    dt = F.softplus(dt.float() + p["dt_bias"])                      # (B,S,H)
    xh = xs.reshape(B, S, H, P)
    # broadcast groups -> heads
    hpg = H // G
    Bh = Bm.repeat_interleave(hpg, dim=2)                           # (B,S,H,N)
    Ch = Cm.repeat_interleave(hpg, dim=2)

    # pad to chunk multiple
    if S_p != S:
        xh = F.pad(xh, (0, 0, 0, 0, 0, S_p - S))
        Bh = F.pad(Bh, (0, 0, 0, 0, 0, S_p - S))
        Ch = F.pad(Ch, (0, 0, 0, 0, 0, S_p - S))
        dt = F.pad(dt, (0, 0, 0, S_p - S))
    nC = S_p // Q
    xc = xh.reshape(B, nC, Q, H, P).float()
    Bc = Bh.reshape(B, nC, Q, H, N).float()
    Cc = Ch.reshape(B, nC, Q, H, N).float()
    dtc = dt.reshape(B, nC, Q, H)

    dA = dtc * A                                                    # (B,nC,Q,H)
    cum = torch.cumsum(dA, dim=2)                                   # within-chunk
    # intra-chunk (diagonal block): y_ij = C_i . B_j * exp(cum_i - cum_j) * dt_j
    Lmask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = _decay(cum[:, :, :, None, :] - cum[:, :, None, :, :])   # (B,nC,Qi,Qj,H)
    CB = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc)
    W = CB * decay * dtc[:, :, None, :, :]
    W = torch.where(Lmask[None, None, :, :, None], W, 0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", W, xc)

    # chunk input states: sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T -> (B,nC,H,N,P)
    seg = _decay(cum[:, :, -1:, :] - cum)                           # (B,nC,Q,H)
    Sin = torch.einsum("bcjhn,bcjhp->bchnp", (seg * dtc)[..., None] * Bc, xc)

    # sequential loop over chunks: h_c = exp(sum dA_c) h_{c-1} + Sin_c
    chunk_decay = _decay(cum[:, :, -1, :])                          # (B,nC,H)
    if state is not None and "ssm" in state:
        h = state["ssm"].float()                                    # (B,H,N,P)
    else:
        h = torch.zeros((B, H, N, P), dtype=Sin.dtype, device=x.device)
    h_prevs = []                                                    # state BEFORE chunk c
    for c in range(nC):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + Sin[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                            # (B,nC,H,N,P)

    # inter-chunk output: y_i += C_i exp(cum_i) h_prev
    inter_decay = _decay(cum)                                       # (B,nC,Q,H)
    y_inter = torch.einsum("bcihn,bchnp->bcihp", Cc * inter_decay[..., None], h_prev)

    y = (y_intra + y_inter).reshape(B, S_p, H, P)[:, :S]
    y = y + xh.reshape(B, S_p, H, P)[:, :S].float() * p["D"].float()[None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    out = y @ p["out_proj"]

    if state is None:
        return out, None
    K = cfg.conv_kernel
    conv_tail = F.pad(xBC_raw, (0, 0, max(K - 1 - S, 0), 0))[:, -(K - 1):]
    state["ssm"].copy_(h)
    state["conv"].copy_(conv_tail)
    return out, {"ssm": state["ssm"], "conv": state["conv"], "pos": state["pos"] + S}


def ssd_decode_step(cfg, p, x, state):
    """Single-token recurrent step.  x (B,1,d); state {ssm (B,H,N,P),
    conv (B,K-1,conv_dim), pos} -> (y (B,1,d), state updated in place)."""
    B = x.shape[0]
    di, G, N, H = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim

    zxbcdt = x @ p["in_proj"]                                       # (B,1,.)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    # conv over (window, new token)
    window = torch.cat([state["conv"], xBC], dim=1)                 # (B,K,D)
    conv_out = (window * p["conv_w"][None]).sum(dim=1, keepdim=True)
    xBC = F.silu(conv_out + p["conv_b"])
    xs = xBC[..., :di]
    Bm = xBC[..., di: di + G * N].reshape(B, G, N)
    Cm = xBC[..., di + G * N:].reshape(B, G, N)
    hpg = H // G
    Bh = Bm.repeat_interleave(hpg, dim=1)                           # (B,H,N)
    Ch = Cm.repeat_interleave(hpg, dim=1)

    A = -torch.exp(p["A_log"].float())
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])               # (B,H)
    decay = torch.exp(dtv * A)                                      # (B,H)
    xhead = xs[:, 0].reshape(B, H, P).float()
    h = state["ssm"] * decay[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", dtv[..., None] * Bh.float(), xhead)
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), h)
    y = y + xhead * p["D"].float()[None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    out = y @ p["out_proj"]
    state["ssm"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return out, {"ssm": state["ssm"], "conv": state["conv"], "pos": state["pos"] + 1}


def init_ssm_state(cfg, batch: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """A zeroed decode state: the float32 SSM state and a conv window of
    ``dtype`` (the activations' dtype: the window holds the projected
    activations as they are), at position 0."""
    di, G, N, H = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    conv_dim = di + 2 * G * N
    return {
        "ssm": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype,
                            device=device),
        "pos": 0,
    }
