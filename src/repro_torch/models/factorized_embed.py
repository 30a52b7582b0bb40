"""CPD-factorized embedding tables (port of ``repro.models.factorized_embed``):
the paper's technique as an LM feature.

A (V, d) embedding table is reshaped to a 3-mode tensor (V1, V2, d) with
V <= V1*V2 and stored as its rank-R CP factors A (V1,R), B (V2,R),
C (d,R):

    E[v, :] = sum_r A[v1, r] * B[v2, r] * C[:, r],   v = v1 * V2 + v2

Parameters drop from V*d to (V1+V2+d)*R -- qwen's 152,064 x 2560 table
at R=256 keeps (390+390+2560)*256 = 0.86M of 389M -- at the cost of an
R-wide Hadamard product per lookup.

The training batch of token ids is a sparse 3-mode tensor X with
nonzeros at (v1(t), v2(t), pos(t)), value 1, and the embedding gradients

    dA[v1, :] += B[v2, :] * <dY[pos, :], C>        (and symmetrically dB)

are exactly the mode-0 and mode-1 spMTTKRP of X with factors
(A, B, dY @ C).  ``grad_factors_mttkrp`` computes them through the
port's MTTKRP front door (``core.mttkrp``): ``backend="slab"``, the
default, runs the hand-written Hopper kernel (``csrc/mttkrp_slab.cu``,
the counterpart of the reference's ``backend="pallas"``) on the card and
its plain PyTorch version on the CPU; ``"segment"`` keeps its name.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.coo import SparseTensor
from ..core.mttkrp import make_plan, mttkrp
from .common import PSpec


def factor_vocab(V: int) -> tuple[int, int]:
    """Near-square (V1, V2) with V1*V2 >= V."""
    v1 = int(np.ceil(np.sqrt(V)))
    v2 = -(-V // v1)
    return v1, v2


def cpd_embed_specs(V: int, d: int, rank: int) -> dict:
    V1, V2 = factor_vocab(V)
    return {
        "A": PSpec((V1, rank), ("vocab", None), "normal", scale=0.5),
        "B": PSpec((V2, rank), ("vocab", None), "normal", scale=0.5),
        "C": PSpec((d, rank), ("fsdp", None), "normal", scale=0.08),
    }


def split_ids(tokens, V: int):
    _, V2 = factor_vocab(V)
    return tokens // V2, tokens % V2


def cpd_embed_lookup(p: dict, tokens: torch.Tensor, V: int) -> torch.Tensor:
    """tokens (B, S) integer -> embeddings (B, S, d)."""
    i1, i2 = split_ids(tokens.long(), V)
    a = p["A"][i1]                            # (B, S, R)
    b = p["B"][i2]                            # (B, S, R)
    return torch.einsum("bsr,dr->bsd", a * b, p["C"])


def dense_table(p: dict, V: int) -> torch.Tensor:
    """Materialized (V, d) table (reference / small-V export)."""
    V1, V2 = factor_vocab(V)
    full = torch.einsum("ir,jr,dr->ijd", p["A"], p["B"], p["C"])
    return full.reshape(V1 * V2, -1)[:V]


def compression_ratio(V: int, d: int, rank: int) -> float:
    V1, V2 = factor_vocab(V)
    return (V * d) / ((V1 + V2 + d) * rank)


# ---------------------------------------------------------------------------
# The gradient as spMTTKRP (the paper's kernel in the training path)
# ---------------------------------------------------------------------------


def batch_as_sparse_tensor(tokens, V: int) -> SparseTensor:
    """The token batch as a 3-mode sparse tensor (V1, V2, n_positions)."""
    V1, V2 = factor_vocab(V)
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    flat = np.asarray(tokens).reshape(-1)
    i1, i2 = flat // V2, flat % V2
    pos = np.arange(flat.shape[0])
    idx = np.stack([i1, i2, pos], axis=1).astype(np.int32)
    vals = np.ones(flat.shape[0], dtype=np.float32)
    return SparseTensor(idx, vals, (V1, V2, flat.shape[0]))


def grad_factors_mttkrp(p: dict, tokens, dY: torch.Tensor, V: int, *,
                        kappa: int = 8, backend: str = "slab"):
    """dLoss/dA and dLoss/dB via the paper's MTTKRP engine, on ``dY``'s
    device.

    dY: (B, S, d) upstream gradient.  Builds the batch sparse tensor, maps
    dY through C (the third 'factor' is dY @ C), and runs mode-0 / mode-1
    spMTTKRP with the adaptive-load-balanced layouts.
    """
    t = batch_as_sparse_tensor(tokens, V)
    g = dY.reshape(-1, dY.shape[-1]) @ p["C"]           # (positions, R)
    factors = [p["A"], p["B"], g]
    plan = make_plan(t, kappa, device=dY.device)
    return (mttkrp(plan, factors, 0, backend=backend),
            mttkrp(plan, factors, 1, backend=backend))
