"""CP state between the JAX package and the port.

A CP state is ``(factors, grams, weights)``: N factor matrices (I_d, R),
their R x R grams and the (R,) weights lambda, whatever the method (the
nncp init and a masked run's state have the same form).
``state_from_reference`` takes the reference's state as numpy arrays --
from ``repro.core.als_device.init_state_host``, a method's
``init_state_host`` or a ``CPDResult`` (whose grams are recomputed) -- and
returns the port's, so both packages start from, and compute, the same
thing.  ``state_to_host`` goes back.

The reference's batched service carries one stacked state, every leaf
with a leading batch dimension (B, ...); the port's carries one state per
lane.  ``batch_from_reference`` and ``batch_to_host`` convert between the
two.

Model parameters and optimizer state are trees of dicts.
``params_from_reference`` turns the reference's (numpy leaves, such as
the CPD embedding factors ``{"A", "B", "C"}`` of
``repro.models.factorized_embed``) into the port's tensors, and
``adamw_state_from_reference`` does the same for an AdamW state
(``repro.optim.init_state`` or a later step's); every family's tree
(MoE experts and router, SSM and Hymba blocks, Whisper's encoder and
decoder stacks) has the same leaves in both packages, so nothing is
mapped.  ``cache_from_reference`` turns a model's cache (numpy leaves:
KV buffers and rings, SSM state and conv window, Whisper's ``self`` /
``cross_k`` / ``cross_v``) into the port's, whose position is a host
``int``.
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


def batch_from_reference(factors, grams, weights, device="cuda"):
    """Port lane states from a stacked reference state: N factor arrays
    (B, I_d, R), N gram arrays (B, R, R) or None (recomputed), weights
    (B, R)."""
    B = np.asarray(weights).shape[0]
    return [state_from_reference([F[b] for F in factors],
                                 None if grams is None else [G[b] for G in grams],
                                 weights[b], device=device)
            for b in range(B)]


def batch_to_host(states):
    """The stacked numpy state ``(factors, grams, weights)``, every leaf
    (B, ...), of a list of port lane states."""
    hosts = [state_to_host(st) for st in states]
    N = len(hosts[0][0])
    return (tuple(np.stack([h[0][d] for h in hosts]) for d in range(N)),
            tuple(np.stack([h[1][d] for h in hosts]) for d in range(N)),
            np.stack([h[2] for h in hosts]))


def stream_state_from_reference(ref, session):
    """Load the host state of a reference ``StreamingCP`` (read by
    attribute: shape, canonical keys, indices, values, entry weights,
    bucket cap, seed, increment and eviction counts, and the factor state
    ``(factors, grams, weights)``) into the port session ``session``,
    which keeps its own configuration (rank, method, backend, policy,
    decay, device).  Returns ``session``."""
    if ref._keys is None:
        raise ValueError("the reference session has not started")
    session._shape = tuple(int(s) for s in ref._shape)
    session._keys = np.array(ref._keys, dtype=np.int64)
    session._idx = np.array(ref._idx)
    session._vals = np.array(ref._vals, dtype=np.float32)
    session._entry_w = (None if ref._entry_w is None
                        else np.array(ref._entry_w, dtype=np.float32))
    session._cap = int(ref._cap)
    session.seed = int(ref.seed)
    session.increments = int(ref.increments)
    session.evictions = int(ref.evictions)
    factors, grams, weights = ref._state
    session._state = (tuple(np.array(F, dtype=np.float32) for F in factors),
                      tuple(np.array(G, dtype=np.float32) for G in grams),
                      np.array(weights, dtype=np.float32))
    return session


def _host_tensor(arr) -> torch.Tensor:
    """A CPU tensor of a numpy array (``ml_dtypes`` bfloat16 included)."""
    arr = np.asarray(arr)
    if str(arr.dtype) == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_reference(tree, device="cuda"):
    """The port's tree (dicts of tensors on ``device``, dtypes kept) of a
    reference parameter tree with numpy leaves, e.g.
    ``jax.tree.map(np.asarray, params)``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_reference(v, dev) for k, v in tree.items()}
    return _host_tensor(tree).to(dev)


def cache_from_reference(cache, device="cuda") -> dict:
    """The port's cache of the reference's (``LM.init_cache``,
    ``EncDec.init_cache`` or a prefill's, numpy leaves, nested dicts
    included): tensors on ``device``, dtypes kept, and ``pos`` as an
    ``int``."""
    dev = resolve_device(device)
    out = {k: (cache_from_reference(v, dev) if isinstance(v, dict)
               else _host_tensor(v).to(dev))
           for k, v in cache.items() if k != "pos"}
    if "pos" in cache:
        out["pos"] = int(np.asarray(cache["pos"]))
    return out


def adamw_state_from_reference(state, device="cuda") -> dict:
    """The port's AdamW state of the reference's ``{"mu", "nu", "step"}``
    (numpy leaves): float32 moments and a 0-d int32 step on ``device``."""
    dev = resolve_device(device)
    return {"mu": params_from_reference(state["mu"], dev),
            "nu": params_from_reference(state["nu"], dev),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                 device=dev)}
