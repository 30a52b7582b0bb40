"""Masked/weighted CP for tensor completion (port of ``repro.methods.masked``).

The COO nonzero list is the OBSERVED-entry set: the goal is
``min sum_{observed e} w_e (x_e - model_e)^2`` with everything off the
list missing, not zero.  EM fills the missing entries with the current
model, ``Xf = model + W * (X - model)``, whose mode-d MTTKRP splits into

  (a) the spMTTKRP over the observed coordinates with per-sweep residual
      values ``w_e * (x_e - model_e)`` -- ``mttkrp_values`` below; the
      substrate runs it through ``ctx.mttkrp_valued``, the kernel's valued
      entry on the slab backend -- and
  (b) the closed-form dense term ``(Y_d * lambda) @ hadamard_{w != d}
      (gram_w)``,

then the ordinary ridge solve shared with plain CP.  The residual is
fresh for every mode (the model moved), which is exact EM; the observed
loss never rises.  Residuals change every sweep, so mode data is
structural only: the canonical->layout permutation, and for slab the
layout->slot scatter computed at pack time.

Per-entry weights are the user's observation confidences
(``cpd_als(method="masked", weights=w)``; omitted weights mean 1), divided
by ``max(1, w.max())`` at every front door.  A weight-0 entry gives a
residual of exactly +-0.0, which the MTTKRP and the fit add as nothing, so
it is exactly an absent entry -- which is also what keeps the serving
path's weight-0 nnz padding exact.

Distributed (``core.distributed.cpd_als_distributed(method="masked")``):
each rank's shard of a mode carries its entries' full coordinates, values
and weights, so the residual is taken at the shard's own coordinates
from the replicated factors (``shard_values``); the partial residual
MTTKRPs are summed over the mesh, the dense correction is computed from
the replicated factors on every rank (no collective), and the weighted
fit sums each shard's residual mass.  The fit is over observed entries:
``1 - sqrt(sum w_e (x_e - model_e)^2) / sqrt(sum w_e x_e^2)``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.ref import cp_model_at_coords
from .registry import MethodSpec, register_method


def make_fit_data(tensor, entry_weights=None, device="cuda"):
    """``(indices, values, entry_weights, weighted ||X||^2)`` on ``device``;
    ``entry_weights`` default to 1 on every observed entry."""
    vals = tensor.values.astype(np.float32)
    ew = (np.ones((tensor.nnz,), np.float32) if entry_weights is None
          else np.asarray(entry_weights, np.float32))
    return (
        torch.as_tensor(tensor.indices, device=device),
        torch.as_tensor(vals, device=device),
        torch.as_tensor(ew, device=device),
        torch.tensor(float((ew * vals) @ vals), dtype=torch.float32,
                     device=device),
    )


def mttkrp_values(ctx, factors, weights, fit_data):
    """Per-mode residual values ``w_e * (x_e - model_e)``, canonical order."""
    indices, values, ew, _ = fit_data
    return ew * (values - cp_model_at_coords(indices, factors, weights))


def shard_values(ctx, factors, weights, shard):
    """The residual values at one rank's valued shard of a mode,
    ``(idx, rows, row_perm, idx_full, vals, ew)``, in the shard's order
    (padding has weight 0, so its residual is exactly +-0.0)."""
    _, _, _, idx_full, vals, ew = shard
    return mttkrp_values(ctx, factors, weights, (idx_full, vals, ew, None))


def update(ctx, d, M_sp, factors, grams, weights, rescue):
    """Residual MTTKRP + closed-form dense term = the MTTKRP of the
    EM-filled tensor (``kernels.ref.mttkrp_masked_residual`` is the
    reference formulation), then the shared solve tail."""
    V = ctx.hadamard(grams, exclude=d)
    M = M_sp + (factors[d] * weights[None, :]) @ V
    Yd, ok = ctx.solve(M, V, rescue)
    Yd, lam = ctx.normalize(Yd)
    return Yd, lam, ok


MASKED = register_method(MethodSpec(
    name="masked",
    description="Masked/weighted CP completion (EM over observed entries): "
                "residual spMTTKRP + closed-form dense term, observed-only "
                "weighted fit; user-supplied per-entry confidences; "
                "padding is weight-0 and therefore exact.",
    update=update,
    mttkrp_values=mttkrp_values,
    shard_values=shard_values,
    make_fit_data=make_fit_data,
    weighted_fit=True,
))
