"""Nonnegative CP via HALS on the shared MTTKRP substrate (port of
``repro.methods.nncp``).

HALS replaces the mode-d normal-equations solve by R exact nonnegative
coordinate minimizations, one per factor column, in column order:

    y_r <- max(0, (M[:, r] - sum_{s != r} y_s V[s, r]) / V[r, r])

with ``M`` the same MTTKRP the plain sweep computes and ``V`` the same
Hadamard of input grams.  Each column update exactly minimizes the loss
over that column subject to y >= 0, so the fit never falls, and the clamp
keeps every factor entry >= 0 from a nonnegative init on.  Factors are
stored column-normalized with the scale in ``weights``; the update
absorbs the weights into the active mode first and re-extracts them.

On the card each column is a handful of small launches (a matrix-vector
product and elementwise ops), R x N of them per sweep, one lane at a
time; they are not fused.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import MethodSpec, register_method

_EPS = 1e-12


def init_state_host_nonneg(tensor_shape, rank: int, seed: int):
    """Strictly nonnegative host init (|N(0,1)| + 0.01), bitwise the
    reference's."""
    rng = np.random.default_rng(seed)
    factors = tuple(
        (np.abs(rng.standard_normal((I, rank))) + 0.01).astype(np.float32)
        for I in tensor_shape
    )
    grams = tuple(F.T @ F for F in factors)
    weights = np.ones((rank,), np.float32)
    return (factors, grams, weights)


def update(ctx, d, M, factors, grams, weights, rescue):
    """HALS mode update.  A column whose gram diagonal collapsed keeps its
    previous value instead of dividing by ~0.  There is no solve, so no
    failure flag (``rescue`` changes nothing)."""
    V = ctx.hadamard(grams, exclude=d)
    Yt = factors[d] * weights[None, :]
    for r in range(ctx.rank):
        num = M[:, r] - Yt @ V[:, r] + Yt[:, r] * V[r, r]
        col = torch.clamp(num, min=0.0) / torch.clamp(V[r, r], min=_EPS)
        Yt[:, r] = torch.where(V[r, r] > _EPS, col, Yt[:, r])
    Yd, lam = ctx.normalize(Yt)
    return Yd, lam, None


NONNEGATIVE = register_method(MethodSpec(
    name="nncp",
    description="Nonnegative CP (HALS): factors >= 0, fit nondecreasing; "
                "same MTTKRP substrate as plain CP.",
    update=update,
    init_state_host=init_state_host_nonneg,
))
