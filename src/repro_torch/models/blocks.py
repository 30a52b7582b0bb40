"""Decoder blocks: dense / MoE / Mamba2 / Hymba-hybrid (port of
``repro.models.blocks``), with the reference's uniform (block_specs,
block_apply, init_block_cache) interface so segments of any kind can be
stacked and cached interchangeably.

Cache dtype may be int8 (quantized KV, per-position absmax scales) -- a
serving optimization for the decode cells.  The SSM state is float32 and
the conv window has the activations' dtype (the parameters' dtype),
whatever the KV cache's dtype: the reference's prefill hands back its
window in that dtype.
"""
from __future__ import annotations

import torch

from . import attention as attn_mod
from . import mlp as mlp_mod
from . import ssm as ssm_mod
from .common import PSpec, apply_norm, norm_specs


def block_specs(cfg, kind: str) -> dict:
    d = cfg.d_model
    if kind == "dense":
        return {
            "ln1": norm_specs(cfg.norm, d),
            "attn": attn_mod.attn_specs(cfg),
            "ln2": norm_specs(cfg.norm, d),
            "mlp": mlp_mod.mlp_specs(cfg),
        }
    if kind == "moe":
        return {
            "ln1": norm_specs(cfg.norm, d),
            "attn": attn_mod.attn_specs(cfg),
            "ln2": norm_specs(cfg.norm, d),
            "moe": mlp_mod.moe_specs(cfg),
        }
    if kind == "mamba":
        return {
            "ln1": norm_specs(cfg.norm, d),
            "ssm": ssm_mod.ssm_specs(cfg),
        }
    if kind == "hymba":
        return {
            "ln1": norm_specs(cfg.norm, d),
            "attn": attn_mod.attn_specs(cfg),
            "ssm": ssm_mod.ssm_specs(cfg),
            "attn_out_scale": {"scale": PSpec((d,), (None,), "zeros")},
            "ssm_out_scale": {"scale": PSpec((d,), (None,), "zeros")},
            "ln2": norm_specs(cfg.norm, d),
            "mlp": mlp_mod.mlp_specs(cfg),
        }
    raise ValueError(f"unknown block kind {kind!r}")


def init_block_cache(cfg, kind: str, batch: int, max_len: int, dtype, quant: bool,
                     device) -> dict:
    if kind not in ("dense", "moe", "mamba", "hymba"):
        raise ValueError(f"unknown block kind {kind!r}")
    cache: dict = {}
    if kind in ("dense", "moe", "hymba"):
        kv_dtype = torch.int8 if quant else dtype
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=kv_dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=kv_dtype, device=device)
        if quant:
            cache["k_scale"] = torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                           device=device)
            cache["v_scale"] = torch.zeros(shape[:3] + (1,), dtype=torch.float32,
                                           device=device)
    if kind in ("mamba", "hymba"):
        st = ssm_mod.init_ssm_state(cfg, batch, cfg.param_dtype, device)
        cache["ssm"] = st["ssm"]
        cache["conv"] = st["conv"]
    return cache


def block_apply(cfg, kind: str, p, x, *, cache=None, pos=None, window=0, q0=0,
                train=True):
    """Apply one block.  Returns (x_out, new_cache, aux_loss).

    ``cache`` is this layer's slice (no 'pos'; the position is passed
    separately so it can live once per segment, not per layer); its
    tensors are updated in place.  ``aux_loss`` is the MoE load-balance
    loss (a float32 scalar tensor) for a ``moe`` block and ``None`` for
    the others (the reference returns a zero).  ``train=False`` switches
    MoE blocks to drop-free dense-eval dispatch.
    """
    new_cache: dict = {}

    if kind == "mamba":
        h = apply_norm(cfg.norm, x, p["ln1"])
        y, st2 = _ssm(cfg, p["ssm"], h, _ssm_state(cache, pos))
        if st2 is not None:
            new_cache.update({"ssm": st2["ssm"], "conv": st2["conv"]})
        return x + y, new_cache, None

    if kind == "hymba":
        h = apply_norm(cfg.norm, x, p["ln1"])
        acache = _attn_cache(cache, pos)
        a, ac2 = attn_mod.attention(cfg, p["attn"], h, cache=acache,
                                    q0=q0, window=window)
        s, st2 = _ssm(cfg, p["ssm"], h, _ssm_state(cache, pos))
        # Hymba: mean of the two normalized branch outputs.
        y = 0.5 * (
            apply_norm("rmsnorm", a, p["attn_out_scale"])
            + apply_norm("rmsnorm", s, p["ssm_out_scale"])
        )
        x = x + y
        h2 = apply_norm(cfg.norm, x, p["ln2"])
        x = x + mlp_mod.mlp_apply(cfg, p["mlp"], h2)
        if ac2 is not None:
            new_cache.update({k: v for k, v in ac2.items() if k != "pos"})
        if st2 is not None:
            new_cache.update({"ssm": st2["ssm"], "conv": st2["conv"]})
        return x, new_cache, None

    if kind not in ("dense", "moe"):
        raise ValueError(f"unknown block kind {kind!r}")
    # dense / moe transformer block
    aux = None
    h = apply_norm(cfg.norm, x, p["ln1"])
    acache = _attn_cache(cache, pos)
    a, ac2 = attn_mod.attention(cfg, p["attn"], h, cache=acache, q0=q0,
                                window=window)
    x = x + a
    h2 = apply_norm(cfg.norm, x, p["ln2"])
    if kind == "moe":
        y, aux = mlp_mod.moe_apply(cfg, p["moe"], h2, train=train)
    else:
        y = mlp_mod.mlp_apply(cfg, p["mlp"], h2)
    x = x + y
    if ac2 is not None:
        new_cache.update({k: v for k, v in ac2.items() if k != "pos"})
    return x, new_cache, aux


def _ssm(cfg, p, h, st):
    """The SSM branch: the recurrent step when a state is present and one
    token comes in, the chunked scan otherwise (the reference's rule)."""
    if st is not None and h.shape[1] == 1:
        return ssm_mod.ssd_decode_step(cfg, p, h, st)
    return ssm_mod.ssd_apply(cfg, p, h, state=st)


def _attn_cache(cache, pos):
    if cache is None or "k" not in cache:
        return None
    c = {"k": cache["k"], "v": cache["v"], "pos": pos}
    if "k_scale" in cache:
        c["k_scale"] = cache["k_scale"]
        c["v_scale"] = cache["v_scale"]
    return c


def _ssm_state(cache, pos):
    if cache is None or "ssm" not in cache:
        return None
    return {"ssm": cache["ssm"], "conv": cache["conv"], "pos": pos}
