"""Decoder blocks (port of ``repro.models.blocks``), with the reference's
uniform (block_specs, block_apply, init_block_cache) interface so
segments of any kind can be stacked and cached interchangeably.

The port runs the ``dense`` kind.  ``moe``, ``mamba`` and ``hymba`` wait
for the ports of the MoE half of ``mlp.py`` and of ``ssm.py``; asking for
one raises ``NotImplementedError``.

Cache dtype may be int8 (quantized KV, per-position absmax scales) -- a
serving optimization for the decode cells.
"""
from __future__ import annotations

import torch

from . import attention as attn_mod
from . import mlp as mlp_mod
from .common import apply_norm, norm_specs

WAITING = ("moe", "mamba", "hymba")


def _check_kind(kind: str) -> None:
    if kind in WAITING:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (the port runs 'dense')")
    if kind != "dense":
        raise ValueError(f"unknown block kind {kind!r}")


def block_specs(cfg, kind: str) -> dict:
    _check_kind(kind)
    d = cfg.d_model
    return {
        "ln1": norm_specs(cfg.norm, d),
        "attn": attn_mod.attn_specs(cfg),
        "ln2": norm_specs(cfg.norm, d),
        "mlp": mlp_mod.mlp_specs(cfg),
    }


def init_block_cache(cfg, kind: str, batch: int, max_len: int, dtype, quant: bool,
                     device) -> dict:
    _check_kind(kind)
    kv_dtype = torch.int8 if quant else dtype
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
             "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
    if quant:
        cache["k_scale"] = torch.zeros(shape[:3] + (1,), dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(shape[:3] + (1,), dtype=torch.float32, device=device)
    return cache


def block_apply(cfg, kind: str, p, x, *, cache=None, pos=None, window=0, q0=0,
                train=True):
    """Apply one block.  Returns (x_out, new_cache, aux_loss).

    ``cache`` is this layer's slice (no 'pos'; the position is passed
    separately so it can live once per segment, not per layer); its
    tensors are updated in place.  ``aux_loss`` is ``None`` for a block
    that has none (the reference returns a zero): the dense kind.
    ``train`` selects the MoE dispatch in the reference; dense blocks do
    not read it.
    """
    _check_kind(kind)
    new_cache: dict = {}
    h = apply_norm(cfg.norm, x, p["ln1"])
    acache = _attn_cache(cache, pos)
    a, ac2 = attn_mod.attention(cfg, p["attn"], h, cache=acache, q0=q0,
                                window=window)
    x = x + a
    h2 = apply_norm(cfg.norm, x, p["ln2"])
    x = x + mlp_mod.mlp_apply(cfg, p["mlp"], h2)
    if ac2 is not None:
        new_cache.update({k: v for k, v in ac2.items() if k != "pos"})
    return x, new_cache, None


def _attn_cache(cache, pos):
    if cache is None or "k" not in cache:
        return None
    c = {"k": cache["k"], "v": cache["v"], "pos": pos}
    if "k_scale" in cache:
        c["k_scale"] = cache["k_scale"]
        c["v_scale"] = cache["v_scale"]
    return c
