"""Logical-axis -> mesh sharding resolution for params, optimizer state,
inputs and caches (port of ``repro.launch.shardings``).

Rules (``models.common``):
  batch   -> (pod, data)     activations' batch dim
  fsdp    -> data            weights' d_model-adjacent dim (ZeRO-3)
  tensor  -> model           heads / d_ff / expert-ff dims (TP)
  experts -> model           MoE expert dim (EP alias of TP axis)
  vocab   -> model           embedding/logits vocab dim
  seq     -> (None|data)     KV-cache seq dim (context parallelism for
                              batch-1 long-context decode)

Every rule application is divisibility-checked per-dim; non-dividing axes
fall back to replication for that dim.

The reference returns ``NamedSharding``s that its compiler executes.  The
port returns the specs themselves, trees of tuples with one entry per dim
(a mesh axis, a tuple of axes, or None), over a mesh described by its axis
names and sizes (``models.common.mesh_shape``).  What the trainer executes
of them is the batch rule on its 1-D ``data`` mesh: each rank takes its
slice of the global batch (``data.TokenPipeline``'s rank slice), and the
train step averages gradients over the ranks (``launch.steps``).
Parameters and optimizer state stay replicated on every rank; the specs
that shard them over ``data`` (ZeRO-3) are computed, not executed.
"""
from __future__ import annotations

from ..models import common as mcommon
from ..models.common import mesh_shape


def _map(fn, *trees):
    """``fn`` leaf by leaf over trees of nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def param_shardings(model, mesh):
    """The spec of every model parameter, from its logical axes."""
    return _map(lambda ax, arr: mcommon.resolve_pspec(ax, tuple(arr.shape), mesh),
                model.param_axes(), model.abstract_params())


def opt_state_shardings(param_shardings_tree, mesh):
    """Adam moments inherit param shardings; step counter replicated."""
    return {"mu": param_shardings_tree, "nu": param_shardings_tree, "step": ()}


def batch_shardings(specs: dict, mesh):
    """Input specs: batch over (pod,data) when divisible; batch-1
    long-context inputs shard nothing (tokens) — their cache shards seq.
    ``specs`` maps each input's name to anything with a ``shape``."""
    return {k: mcommon.resolve_pspec(("batch",) + (None,) * (len(v.shape) - 1),
                                     tuple(v.shape), mesh)
            for k, v in specs.items()}


def cache_shardings(cache_tree, mesh, *, seq_axis_ok: bool,
                    kv_model_axis: bool = False,
                    kv_seq_model: bool = False):
    """KV/SSM cache specs.

    Layout per leaf (stacked segments): (L, B, S, KH, hd) / (L, B, H, N, P)
    or unstacked (B, S, ...).  Batch shards over (pod,data) when divisible;
    otherwise (batch-1 long context) the seq dim shards over data.  The
    host ``int`` position (``pos``) is replicated.

    kv_model_axis: additionally shard the kv-heads dim (or head_dim when
    head count doesn't divide) over 'model' — TP-sharded KV cache.
    """
    avail = mesh_shape(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in avail)
    batch_size = 1
    for a in batch_axes:
        batch_size *= avail[a]

    def resolve(arr):
        if not hasattr(arr, "shape") or len(arr.shape) == 0:
            return ()
        shape, ndim = tuple(arr.shape), len(arr.shape)
        # find the batch dim: first dim for unstacked, second for stacked
        # heuristics: stacked leaves have ndim >= 4 with dim0 == n_layers.
        spec = [None] * ndim
        bdim = 0 if ndim <= 3 else 1
        sdim = bdim + 1
        if shape[bdim] % batch_size == 0 and batch_size > 1:
            spec[bdim] = batch_axes if len(batch_axes) > 1 else batch_axes[0]
        elif (
            seq_axis_ok
            and "data" in avail
            and ndim > sdim
            and shape[sdim] % avail["data"] == 0
            and shape[sdim] > 1024
        ):
            spec[sdim] = "data"   # context parallelism over the cache seq
        if (kv_seq_model and "model" in avail and ndim >= sdim + 3
                and spec[sdim] is None and shape[sdim] % avail["model"] == 0
                and shape[sdim] > avail["model"]):
            # flash-decoding style: split the cache SEQ dim over 'model'
            spec[sdim] = "model"
        elif kv_model_axis and "model" in avail and ndim >= sdim + 3:
            # (..., S, KH, hd): prefer the head dim, fall back to head_dim
            for dim in (sdim + 1, sdim + 2):
                if shape[dim] % avail["model"] == 0 and shape[dim] > 1:
                    spec[dim] = "model"
                    break
        return tuple(spec)

    return _map(resolve, cache_tree)

