"""Int8 error-feedback gradient compression for the cross-pod hop (port of
``repro.optim.compress``).

Int8 quantization with error feedback (the residual is carried to the
next step) cuts the bytes of a cross-pod gradient mean 4x against fp32
at negligible fit cost.  The reference runs it under ``shard_map`` over
the 'pod' axis; here ``compressed_psum_leaf`` and ``cross_pod_mean``
run on every rank of a 1-D ``launch.mesh.Mesh`` and sum through its
``psum``.  As in the reference, a mesh without the axis returns its
inputs.
"""
from __future__ import annotations

import torch

from .adamw import tree_map


def quantize(x: torch.Tensor, axis=None):
    """Symmetric int8 with one float32 scale (per ``axis`` slice, else for
    the whole tensor, keeping ``x``'s rank)."""
    dims = tuple(range(x.dim())) if axis is None else axis
    amax = x.abs().amax(dim=dims, keepdim=True) if x.dim() else x.abs()
    scale = torch.clamp(amax, min=1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_leaf(g: torch.Tensor, err: torch.Tensor, mesh):
    """Error-feedback int8 mean of one leaf over ``mesh``.

    The wire payload is the int8 tensor + one fp32 scale per rank; the
    quantization error is carried into the next step (error feedback), so
    the scheme is unbiased over time.  Returns (mean grad fp32, residual).
    """
    g32 = g.float() + err
    q, scale = quantize(g32)
    deq = dequantize(q, scale)
    return mesh.psum(deq) / float(mesh.size), g32 - deq


def cross_pod_mean(grads, err_state, mesh, *, compress: bool = True,
                   axis_name: str = "pod"):
    """Mean gradients across the mesh's ``axis_name`` axis, optionally
    int8-compressed with error feedback.  grads/err_state are trees of
    one structure; returns (grads, new_err)."""
    if axis_name not in mesh.axis_names:
        return grads, err_state

    def body(g, e):
        if not compress:
            return mesh.psum(g.float()) / float(mesh.size), e
        return compressed_psum_leaf(g, e, mesh)

    out = tree_map(body, grads, err_state)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)
