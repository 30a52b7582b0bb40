"""Shared model machinery (port of ``repro.models.common``): parameter
specs, logical-axis sharding rules, norms, RoPE, losses.

Parameters are described ONCE as ``PSpec`` trees (shape + logical axes +
init), nested dicts with ``PSpec`` leaves; ``build_params`` draws tensors
from an explicit ``torch.Generator`` with the reference's distributions
(the numbers differ: JAX's PRNG is not reproduced, so parity tests load
the reference's arrays through ``repro_torch.convert``),
``abstract_params`` gives shape-and-dtype tensors on the ``meta`` device
(the dry-run counterpart of ``jax.ShapeDtypeStruct``), ``logical_axes``
the matching axes tree.  ``set_rules``, ``get_rules``, ``reset_rules``,
``to_pspec`` and ``resolve_pspec`` resolve logical axes to mesh axes as
the reference does (``launch/shardings.py`` applies them), over a mesh
described by its axis names and sizes; a spec is a tuple with one entry
per dim (a mesh axis name, a tuple of names, or None), the reference's
``PartitionSpec`` as a tuple.  ``constrain`` is the identity: the port is
multi-controller, and no rank holds a global array to constrain.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Any

import torch
import torch.utils.checkpoint

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
# Logical-axis sharding rules
# ---------------------------------------------------------------------------

# Default logical -> mesh translation; launch/shardings.py may override via
# set_rules().  Tuples mean "sharded over multiple mesh axes".
_DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": "data",        # weight embed-dim sharding (ZeRO-3)
    "tensor": "model",     # TP: heads / d_ff / vocab
    "experts": "model",
    "seq": None,           # set to 'data' for context-parallel decode
    "seq_act": None,       # set to 'model' for Megatron-SP residual stream
    "kv_heads": None,      # set to 'model' for TP-sharded KV caches
    "kv_hd": None,         # fallback when kv head count doesn't divide
    "layers": None,
    "vocab": "model",
}
_rules = dict(_DEFAULT_RULES)


def set_rules(**kw):
    _rules.update(kw)


def get_rules() -> dict:
    return dict(_rules)


def reset_rules():
    _rules.clear()
    _rules.update(_DEFAULT_RULES)


def mesh_shape(mesh) -> dict[str, int]:
    """A mesh's axis sizes by name.  ``mesh`` is a mapping of them, or an
    object with ``axis_names`` and ``axis_sizes`` (``launch.mesh.Mesh``)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.axis_names, (int(n) for n in mesh.axis_sizes)))


def to_pspec(axes: tuple, mesh=None) -> tuple:
    """The rules' mesh axes for ``axes``, one entry per dim, unchecked
    against any mesh (``resolve_pspec`` checks)."""
    return tuple(_rules.get(a) if isinstance(a, str) else None for a in axes)


def resolve_pspec(axes: tuple, shape: tuple, mesh) -> tuple:
    """The spec with divisibility + axis-existence checks per dim.

    A mesh axis may appear at most once in a spec, so logical axes are
    resolved left-to-right and later dims drop any mesh axis already
    claimed (e.g. MoE ('experts','fsdp','tensor') -> ('model','data',None):
    the expert dim wins the model axis; per-expert ff stays unsharded)."""
    avail = mesh_shape(mesh)
    used: set = set()
    out = []
    for dim, a in zip(shape, axes):
        r = _rules.get(a) if isinstance(a, str) else None
        if r is None:
            out.append(None)
            continue
        axes_tuple = (r,) if isinstance(r, str) else tuple(r)
        axes_tuple = tuple(x for x in axes_tuple if x in avail and x not in used)
        size = math.prod(avail[x] for x in axes_tuple)
        if axes_tuple and dim % size == 0:
            out.append(axes_tuple if len(axes_tuple) > 1 else axes_tuple[0])
            used.update(axes_tuple)
        else:
            out.append(None)
    return tuple(out)


def constrain(x, *axes):
    """The identity.  The reference pins an activation's sharding inside
    its one global program; each rank of the port computes on its own
    shard, so there is nothing to constrain."""
    return x


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


def records_grad(*trees) -> bool:
    """True when autograd records a graph through a tensor of ``trees``
    (nested dicts, lists and tuples; other leaves are ignored)."""
    if not torch.is_grad_enabled():
        return False
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            return True
    return False


def remat_layer(cfg, *trees) -> bool:
    """Checkpoint a layer over ``trees``: ``cfg.remat`` asks for it
    (``full`` and ``dots`` alike) and autograd records a graph through
    them; serving never does."""
    return cfg.remat != "none" and records_grad(*trees)


def remat(fn, *args):
    """``fn(*args)`` keeping none of its intermediates for the backward,
    which recomputes them (``jax.checkpoint``).  The models draw no random
    numbers, so no RNG state is kept for the recomputation."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def pad_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple
