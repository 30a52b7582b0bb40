"""Grouped-query attention with flash-style chunked online softmax (port of
``repro.models.attention``).

The reference computes attention in plain XLA, with no Pallas kernel
(its docstring says why), so this module ports no kernel either: it is
the same online softmax in PyTorch, its chunk loops written as Python
loops.  ``scaled_dot_product_attention`` would be a speed change, not a
port.

Supports: GQA (num_kv_heads < num_heads), QKV bias (Qwen), RoPE or
sinusoidal positions, sliding-window masks (Hymba), cross-attention
(Whisper), KV-cache decode into a full buffer, a window-sized ring or an
int8 cache.

Two departures from the reference, neither changing a number:
- The cache is updated in place.  The reference returns new buffers (and
  its launcher donates the old ones); here ``attention`` writes the new
  keys and values into the cache's tensors and returns a dict of the
  same tensors.  ``cache["pos"]`` is a host ``int``: the host always
  knows how many tokens it has fed, so decoding reads nothing back.
- ``attn_bf16_dot`` rounds both operands to bfloat16 and multiplies them
  in float32, which is exact for bf16 products; the reference asks the
  MXU for bf16 operands with f32 accumulation.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .common import PSpec, apply_rope, rope_freqs

NEG_INF = -2.0e38


def attn_specs(cfg, *, cross: bool = False) -> dict:
    d = cfg.d_model
    qf = cfg.num_heads * cfg.head_dim
    kf = cfg.num_kv_heads * cfg.head_dim
    specs = {
        "wq": PSpec((d, qf), ("fsdp", "tensor")),
        "wk": PSpec((d, kf), ("fsdp", "tensor")),
        "wv": PSpec((d, kf), ("fsdp", "tensor")),
        "wo": PSpec((qf, d), ("tensor", "fsdp")),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = PSpec((qf,), (None,), "zeros")
        specs["bk"] = PSpec((kf,), (None,), "zeros")
        specs["bv"] = PSpec((kf,), (None,), "zeros")
    return specs


def _project_qkv(cfg, p, xq, xkv):
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, Sq, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, Skv, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, Skv, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _positions_embed(cfg, q, k, q_pos, k_pos):
    if cfg.pos_embedding == "rope":
        cq, sq = rope_freqs(cfg.head_dim, cfg.rope_theta, q_pos)
        ck, sk = rope_freqs(cfg.head_dim, cfg.rope_theta, k_pos)
        q = apply_rope(q, cq, sq)
        k = apply_rope(k, ck, sk)
    return q, k


def _operand(x, bf16: bool):
    """A dot operand in float32, first rounded to bfloat16 if ``bf16``."""
    return x.to(torch.bfloat16).float() if bf16 else x.float()


def _chunked_attention(
    q, k, v, *, num_kv: int, q0, causal: bool, window: int, chunk: int,
    bf16_dot: bool = False,
):
    """Flash-style attention.  q (B,Sq,H,hd), k/v (B,Skv,KH,hd) -> (B,Sq,H,hd).

    Loops over q in chunks of `chunk`; the inner loop over kv chunks keeps
    running (max, denom, acc) -- peak memory O(B*H*chunk^2) instead of
    O(B*H*Sq*Skv).  ``q0`` is the absolute position of q[0] (decode offset
    / meta tokens).  Returns float32.
    """
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    G = H // num_kv
    scale = hd ** -0.5
    dev = q.device

    qc = min(chunk, Sq)
    kc = min(chunk, Skv)
    # pad to multiples
    Sq_p = -(-Sq // qc) * qc
    Skv_p = -(-Skv // kc) * kc
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, Sq_p - Sq))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, Skv_p - Skv))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Skv_p - Skv))
    nq, nk = Sq_p // qc, Skv_p // kc

    qs = _operand(q.reshape(B, nq, qc, num_kv, G, hd).float() * scale, bf16_dot)
    ks = _operand(k.reshape(B, nk, kc, num_kv, hd), bf16_dot)
    vs = _operand(v.reshape(B, nk, kc, num_kv, hd), bf16_dot)
    kv_valid = (torch.arange(Skv_p, device=dev) < Skv).reshape(nk, kc)

    outs = []
    for qi in range(nq):
        qchunk = qs[:, qi]                                  # (B,qc,KH,G,hd)
        q_pos = q0 + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, num_kv, G, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, num_kv, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, num_kv, G, qc, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            k_pos = ki * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qchunk, ks[:, ki])  # (B,KH,G,qc,kc)
            mask = kv_valid[ki][None, :]
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", _operand(p, bf16_dot), vs[:, ki])
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)    # (B,KH,G,qc,hd)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qc, num_kv * G, hd))
    return torch.cat(outs, dim=1)[:, :Sq]


def _write(buf, x_new, start: int):
    """``buf[:, start:start+S] = x_new`` in place, the start clamped into
    the buffer as ``lax.dynamic_update_slice`` clamps it."""
    S = x_new.shape[1]
    start = max(0, min(start, buf.shape[1] - S))
    buf[:, start:start + S] = x_new.to(buf.dtype)
    return buf


def attention(
    cfg,
    p: dict,
    x,
    *,
    xkv=None,                 # cross-attention context (None = self)
    cache: dict | None = None,
    q0=0,                     # absolute position of first query
    causal: bool = True,
    window: int = 0,
):
    """Full attention block: project -> rope -> (cache) -> attend -> out-proj.

    cache: {"k","v": (B, S_max, KH, hd), "pos": int} -- decode writes at
    ``pos`` and attends over the slots filled so far.  The cache's
    tensors are updated in place.  Returns (out (B,Sq,d), cache with the
    same tensors and ``pos`` advanced | None).
    """
    B, Sq, _ = x.shape
    # cross-attention: fresh context (xkv) or precomputed KV (cache w/o pos)
    cross = xkv is not None or (cache is not None and "pos" not in cache)
    src = xkv if xkv is not None else x
    q, k, v = _project_qkv(cfg, p, x, src)

    new_cache = None
    if cache is not None and cross:
        # cross-attention against precomputed encoder KV (no causal mask)
        out = _decode_attention(cfg, q, cache["k"], cache["v"], 0, Sq,
                                causal=False, window=0, full_len=True)
    elif cache is not None and Sq <= 8:
        # decode: rope at absolute cache position, append, single-pass attend
        pos = cache["pos"]
        S_buf = cache["k"].shape[1]
        ring = bool(window) and S_buf == window   # window-sized ring buffer
        k_pos = pos + torch.arange(Sq, device=x.device)
        q, k = _rope_decode(cfg, q, k, k_pos)
        wpos = (pos % S_buf) if ring else pos
        if "k_scale" in cache:  # int8-quantized cache
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            new_cache = {"k": _write(cache["k"], kq, wpos),
                         "v": _write(cache["v"], vq, wpos),
                         "k_scale": _write(cache["k_scale"], ks, wpos),
                         "v_scale": _write(cache["v_scale"], vs, wpos),
                         "pos": pos + Sq}
            k_eff = new_cache["k"].to(torch.bfloat16) * new_cache["k_scale"].to(torch.bfloat16)
            v_eff = new_cache["v"].to(torch.bfloat16) * new_cache["v_scale"].to(torch.bfloat16)
        else:
            new_cache = {"k": _write(cache["k"], k, wpos),
                         "v": _write(cache["v"], v, wpos),
                         "pos": pos + Sq}
            k_eff, v_eff = new_cache["k"], new_cache["v"]
        slots = torch.arange(S_buf, device=x.device)
        if ring:
            # absolute position stored in each ring slot (-1 if not yet used)
            kp = pos - torch.remainder(pos - slots, S_buf)
            slot_pos = torch.where(kp <= pos, kp, -1)
        else:
            slot_pos = slots
        out = _decode_attention(cfg, q, k_eff, v_eff, pos, Sq,
                                causal=causal, window=window,
                                slot_pos=slot_pos)
    else:
        # train / prefill: chunked flash-style attention
        positions = q0 + torch.arange(Sq, device=x.device)
        kv_positions = torch.arange(src.shape[1], device=x.device) + (0 if cross else q0)
        if cfg.pos_embedding == "rope" and not cross:
            q, k = _positions_embed(cfg, q, k, positions[None], kv_positions[None])
        out = _chunked_attention(
            q, k, v, num_kv=cfg.num_kv_heads, q0=q0,
            causal=causal and not cross, window=window, chunk=cfg.attn_chunk,
            bf16_dot=getattr(cfg, "attn_bf16_dot", False),
        )
        if cache is not None:
            # prefill: persist KV into the cache buffer.  Window-sized ring
            # buffers keep only the last S_buf tokens, placed at slot
            # (absolute_position % S_buf) so decode can continue the ring.
            S_buf = cache["k"].shape[1]
            pos0 = cache["pos"]

            def _store(buf, x_new):
                if Sq <= S_buf:
                    return _write(buf, x_new, pos0 % S_buf if S_buf > 1 else pos0)
                tail_pos = pos0 + Sq - S_buf + torch.arange(S_buf, device=x.device)
                buf[:, tail_pos % S_buf] = x_new[:, -S_buf:].to(buf.dtype)
                return buf

            if "k_scale" in cache:
                kq, ks = quantize_kv(k)
                vq, vs = quantize_kv(v)
                new_cache = {
                    "k": _store(cache["k"], kq),
                    "v": _store(cache["v"], vq),
                    "k_scale": _store(cache["k_scale"], ks),
                    "v_scale": _store(cache["v_scale"], vs),
                    "pos": pos0 + Sq,
                }
            else:
                new_cache = {
                    "k": _store(cache["k"], k),
                    "v": _store(cache["v"], v),
                    "pos": pos0 + Sq,
                }

    out = out.to(x.dtype).reshape(B, Sq, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"], new_cache


def _rope_decode(cfg, q, k, k_pos):
    """Apply rope at absolute cache positions (decode: q at pos..pos+Sq)."""
    if cfg.pos_embedding != "rope":
        return q, k
    c, s = rope_freqs(cfg.head_dim, cfg.rope_theta, k_pos[None, :])
    return apply_rope(q, c, s), apply_rope(k, c, s)


def _decode_attention(cfg, q, k, v, pos, Sq, *, causal, window,
                      full_len=False, slot_pos=None):
    """Single-pass attention of Sq queries against a (possibly partially
    filled) cache of length S_max.  Memory (B,H,Sq,S_max) f32 scores --
    fine for Sq<=8.

    ``slot_pos`` (S_max,) gives the absolute token position held by each
    cache slot (ring buffers permute it; -1 marks unused slots)."""
    B, _, H, hd = q.shape
    KH = cfg.num_kv_heads
    G = H // KH
    S_max = k.shape[1]
    dev = q.device
    bf16 = getattr(cfg, "attn_bf16_dot", False)
    if bf16:
        # bf16 operands, f32 products and sums; never makes an f32 copy of
        # the cache's bf16 values beyond the operand itself
        q5 = _operand(q.reshape(B, Sq, KH, G, hd) * hd**-0.5, True)
    else:
        q5 = q.reshape(B, Sq, KH, G, hd).float() * hd**-0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", q5, _operand(k, bf16))
    k_idx = torch.arange(S_max, device=dev) if slot_pos is None else slot_pos
    q_pos = pos + torch.arange(Sq, device=dev)
    if full_len:
        valid = torch.ones((Sq, S_max), dtype=torch.bool, device=dev)
    else:
        valid = (k_idx[None, :] >= 0).expand(Sq, S_max)
        if causal:
            valid = valid & (k_idx[None, :] <= q_pos[:, None])
        if window:
            valid = valid & (k_idx[None, :] > q_pos[:, None] - window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", _operand(p, bf16), _operand(v, bf16))
    return out.reshape(B, Sq, H, hd)


def quantize_kv(x):
    """Per-(batch, position, head) absmax int8 quantization of (B,S,KH,hd)."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def init_attn_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                    device="cuda") -> dict:
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "pos": 0,
    }
