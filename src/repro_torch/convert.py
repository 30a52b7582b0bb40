"""CP state between the JAX package and the port.

A CP state is ``(factors, grams, weights)``: N factor matrices (I_d, R),
their R x R grams and the (R,) weights lambda.  ``state_from_reference``
takes the reference's state as numpy arrays -- from
``repro.core.als_device.init_state_host`` or from a ``CPDResult`` (whose
grams are recomputed) -- and returns the port's, so both packages start
from, and compute, the same thing.  ``state_to_host`` goes back.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def state_from_reference(factors, grams, weights, device="cuda"):
    """Port state (float32 tensors on ``device``) from numpy arrays.
    ``grams=None`` recomputes ``F.T @ F`` in float32 on the host."""
    dev = resolve_device(device)
    factors = tuple(np.array(F, dtype=np.float32) for F in factors)
    if grams is None:
        grams = tuple(F.T @ F for F in factors)
    return (
        tuple(torch.as_tensor(F, device=dev) for F in factors),
        tuple(torch.as_tensor(np.array(G, dtype=np.float32), device=dev)
              for G in grams),
        torch.as_tensor(np.array(weights, dtype=np.float32), device=dev),
    )


def state_to_host(state):
    """Numpy ``(factors, grams, weights)`` of a port state."""
    factors, grams, weights = state
    return (tuple(F.cpu().numpy() for F in factors),
            tuple(G.cpu().numpy() for G in grams),
            weights.cpu().numpy())
