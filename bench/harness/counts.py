"""The work a CP-ALS sweep needs, counted from the problem alone, and the
card's peaks it is read against.

Nothing here looks at how the program packs or computes: a later change
to the program leaves these counts as they are.  Float32 throughout.

One mode-d MTTKRP reads each nonzero's N indices and its value once
(``nnz * (4N + 4)`` bytes), each input factor once (``I_w * R * 4``),
writes its output once (``I_d * R * 4``), and does ``nnz * R * N``
operations (N - 1 products and one sum per nonzero and column).  A sweep
adds per mode the gram ``F_d^T F_d`` and the solve against the R x R
normal matrix (``4 I_d R^2 + R^3`` operations, no bytes beyond the
MTTKRP's) and, for the fit, ``2 I_N R`` operations: ``<X, X_hat>`` is
``sum_r lam_r sum_i M_N[i, r] F_N[i, r]`` from the last mode's MTTKRP.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W.
PEAKS = {
    "name": "NVIDIA H100 SXM",
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,      # outside the tensor cores
    "hbm_bytes": 80e9,
}

F32 = 4
INDEX = 4


def mttkrp_counts(shape, nnz: int, rank: int, mode: int) -> dict:
    """``{"bytes", "flops"}`` of one mode's MTTKRP."""
    n = len(shape)
    factor_bytes = sum(int(shape[w]) for w in range(n) if w != mode) * rank * F32
    return {"bytes": nnz * (INDEX * n + F32) + factor_bytes
            + int(shape[mode]) * rank * F32,
            "flops": nnz * rank * n}


def sweep_counts(shape, nnz: int, rank: int) -> dict:
    """``{"bytes", "flops"}`` of one sweep: N MTTKRPs, grams, solves, fit."""
    total = {"bytes": 0, "flops": 0}
    for d in range(len(shape)):
        c = mttkrp_counts(shape, nnz, rank, d)
        total["bytes"] += c["bytes"]
        total["flops"] += c["flops"] + 4 * int(shape[d]) * rank ** 2 + rank ** 3
    total["flops"] += 2 * int(shape[-1]) * rank
    return total


def least_seconds(counts: dict, peaks: dict = PEAKS) -> float:
    """The least time the card could take: bytes at its memory rate or
    operations at its float32 rate, whichever is longer."""
    return max(counts["bytes"] / peaks["hbm_bytes_per_s"],
               counts["flops"] / peaks["fp32_flops_per_s"])

