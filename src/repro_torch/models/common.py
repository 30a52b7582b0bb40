"""Shared model machinery (port of ``repro.models.common``): parameter
specs, norms, RoPE, losses.

Parameters are described ONCE as ``PSpec`` trees (shape + logical axes +
init), nested dicts with ``PSpec`` leaves; ``build_params`` draws tensors
from an explicit ``torch.Generator`` with the reference's distributions
(the numbers differ: JAX's PRNG is not reproduced, so parity tests load
the reference's arrays through ``repro_torch.convert``),
``abstract_params`` gives shape-and-dtype tensors on the ``meta`` device
(the dry-run counterpart of ``jax.ShapeDtypeStruct``), ``logical_axes``
the matching axes tree.  The logical axes stay metadata: the reference's
rules that resolve them to mesh axes (``set_rules``, ``to_pspec``,
``resolve_pspec``, ``constrain``) wait for the port of
``launch/shardings.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..device import resolve_device

# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PSpec:
    """One parameter: shape, logical sharding axes, initializer."""

    shape: tuple[int, ...]
    axes: tuple[Any, ...]           # logical axis name (str) or None per dim
    init: str = "fan_in"            # fan_in | normal | zeros | ones | embed
    scale: float = 1.0
    dtype: torch.dtype | None = None    # None -> model default

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _map_specs(fn, tree):
    """``fn`` on every ``PSpec`` of a tree of dicts, lists and tuples."""
    if isinstance(tree, PSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def stack_specs(tree, n: int):
    """Prepend a ('layers',) stacking dim of size n to every spec in tree."""
    return _map_specs(
        lambda s: PSpec((n, *s.shape), ("layers", *s.axes), s.init, s.scale, s.dtype),
        tree)


def _init_tensor(spec: PSpec, generator: torch.Generator, default_dtype,
                 device) -> torch.Tensor:
    dtype = spec.dtype or default_dtype
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init in ("normal", "embed"):
        std = spec.scale
    elif spec.init == "fan_in":
        # stacked specs: fan_in excludes the leading 'layers' dim
        dims = shape[1:] if spec.axes and spec.axes[0] == "layers" else shape
        fan_in = dims[0] if dims else 1
        std = spec.scale / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    z = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (std * z).to(device=device, dtype=dtype)


def build_params(specs, generator: torch.Generator,
                 default_dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """The spec tree's tensors on ``device``: normals drawn in float32 from
    ``generator`` (one draw per leaf, in ``jax.tree.flatten``'s leaf
    order: dict keys sorted), scaled, then cast to the leaf's dtype."""
    dev = resolve_device(device)

    def build(tree):
        if isinstance(tree, PSpec):
            return _init_tensor(tree, generator, default_dtype, dev)
        if isinstance(tree, dict):
            drawn = {k: build(tree[k]) for k in sorted(tree)}
            return {k: drawn[k] for k in tree}
        return type(tree)(build(v) for v in tree)

    return build(specs)


def abstract_params(specs, default_dtype: torch.dtype = torch.bfloat16):
    """The spec tree as ``meta`` tensors: shapes and dtypes, no storage."""
    return _map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype or default_dtype, device="meta"),
        specs)


def logical_axes(specs):
    return _map_specs(lambda s: s.axes, specs)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-6):
    """Cast back to ``x``'s dtype before the ``(1 + scale)`` product, as the
    reference does (it decides the bf16 rounding)."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * (1.0 + scale.to(dt))


def layer_norm(x, scale, bias, eps=1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


def apply_norm(kind: str, x, p):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def norm_specs(kind: str, d: int) -> dict:
    if kind == "rmsnorm":
        return {"scale": PSpec((d,), (None,), "zeros")}
    return {"scale": PSpec((d,), (None,), "ones"), "bias": PSpec((d,), (None,), "zeros")}


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions: (..., S) int -> cos/sin (..., S, head_dim/2) f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) or (S, hd/2)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def softmax_cross_entropy(logits, labels, *, z_loss: float = 1e-4, mask=None):
    """logits (B,S,V) f32-upcast CE with optional z-loss and label mask.
    labels < 0 are ignored."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe_labels = torch.clamp(labels, min=0).long()
    ll = torch.gather(logits, -1, safe_labels[..., None])[..., 0]
    ce = lse - ll
    if z_loss:
        ce = ce + z_loss * lse ** 2
    valid = (labels >= 0).float()
    if mask is not None:
        valid = valid * mask.float()
    return (ce * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def pad_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple
