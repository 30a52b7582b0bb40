"""Step-function builders (port of ``repro.launch.steps``): train, prefill
and greedy decode.

``make_train_step`` differentiates ``model.loss`` with ``torch.autograd``
where the reference uses ``jax.value_and_grad``, accumulates microbatches
in order as its ``lax.scan`` does, and on a mesh of several ranks
averages the gradients and the loss over them (data parallelism: each
rank holds its slice of the global batch).  The step reads nothing back
to the host; on the card it runs PyTorch's deterministic kernels
(``device.deterministic_algorithms``), so a run repeats bit for bit and a
restart from a checkpoint continues as the uninterrupted run would.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch

from .. import optim
from ..device import deterministic_algorithms
from ..optim.adamw import tree_leaves, tree_map


def _like(tree, leaves):
    """A tree of ``tree``'s structure with ``leaves`` in its leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_grad_fn(model, *, microbatch: int = 1):
    """Returns grads(params, batch) -> (grads, metrics): the gradient of
    ``model.loss`` with respect to every leaf of ``params`` (a tree of the
    same structure; each leaf's dtype, float32 with ``microbatch > 1``) and
    the loss's metrics, detached.  ``microbatch > 1`` runs the batch's
    ``microbatch`` equal slices in order, sums their float32 gradients and
    divides by ``microbatch``; its metrics are the mean loss alone, as the
    reference's."""

    def one(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        for p in leaves:
            if not p.is_floating_point():
                raise TypeError(f"cannot differentiate a {p.dtype} parameter")
        with torch.enable_grad():
            loss, metrics = model.loss(_like(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return _like(params, grads), {k: v.detach() for k, v in metrics.items()}

    def grads(params, batch):
        if microbatch == 1:
            return one(params, batch)
        B = batch["tokens"].shape[0]
        if B % microbatch:
            raise ValueError(f"batch {B} does not split into {microbatch} microbatches")
        mb = B // microbatch
        acc = loss_sum = None      # the reference's zeros: 0 + x is x
        for i in range(microbatch):
            g, metrics = one(params, {k: v[i * mb:(i + 1) * mb]
                                      for k, v in batch.items()})
            g = tree_map(lambda x: x.float(), g)
            acc = g if acc is None else tree_map(torch.add, acc, g)
            loss = metrics["loss"].float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return (tree_map(lambda a: a / microbatch, acc),
                {"loss": loss_sum / microbatch})

    return grads


def _mesh_mean(mesh, grads, metrics):
    """``grads`` and ``metrics`` averaged over the mesh's ranks: one
    all-reduce of a float32 buffer that holds every gradient and metric.
    The gradients come back float32."""
    leaves = tree_leaves(grads)
    names = sorted(metrics)
    flat = torch.cat([g.float().reshape(-1) for g in leaves]
                     + [metrics[k].float().reshape(1) for k in names])
    flat = mesh.psum(flat) / mesh.size
    parts = flat.split([g.numel() for g in leaves] + [1] * len(names))
    out = [p.view(g.shape) for p, g in zip(parts, leaves)]
    return (_like(grads, out),
            {k: p[0] for k, p in zip(names, parts[len(leaves):])})


def make_train_step(model, opt_cfg: optim.AdamWConfig, *, microbatch: int = 1,
                    mesh=None, deterministic: bool = True):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``microbatch > 1`` accumulates gradients over batch slices
    (sequential, memory-bounded).  On a ``mesh`` of several ranks, each
    holding its slice of the global batch, the gradients and metrics are
    averaged over the ranks before the update.  ``deterministic`` runs the
    step under ``device.deterministic_algorithms``.  The inputs are left as
    they were; the metrics (loss, grad_norm, lr, ...) stay on the device."""
    grad_fn = make_grad_fn(model, microbatch=microbatch)

    def train_step(params, opt_state, batch):
        guard = deterministic_algorithms() if deterministic else contextlib.nullcontext()
        with guard:
            grads, metrics = grad_fn(params, batch)
            if mesh is not None and mesh.size > 1:
                grads, metrics = _mesh_mean(mesh, grads, metrics)
            params, opt_state, om = optim.apply_updates(opt_cfg, params, grads,
                                                        opt_state)
        return params, opt_state, {**metrics, **om}

    return train_step


def greedy(logits) -> torch.Tensor:
    """The next token of each sequence, on the device: argmax of the last
    position's logits (B, S, V) -> (B,) int32."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def make_prefill_step(model):
    def prefill_step(params, cache, batch):
        kw: dict[str, Any] = {}
        if "prefix_embeds" in batch:
            kw["prefix_embeds"] = batch["prefix_embeds"]
        if "encoder_embeds" in batch:
            kw["encoder_embeds"] = batch["encoder_embeds"]
        return model.prefill(params, batch["tokens"], cache, **kw)

    return prefill_step


def make_decode_step(model, logits_out: list | None = None):
    """decode_step(params, cache, batch) -> (next token ids (B,) int32,
    cache).  Serving returns token ids, not logits, to keep the host
    transfer tiny; a caller that checks the logits passes ``logits_out``,
    a list to which each step appends its (B, V) logits (device tensors)."""
    def decode_step(params, cache, batch):
        logits, cache = model.decode_step(params, batch["tokens"], cache)
        if logits_out is not None:
            logits_out.append(logits[:, -1])
        return greedy(logits), cache

    return decode_step
