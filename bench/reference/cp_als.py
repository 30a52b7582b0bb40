"""Plain CP-ALS on a sparse COO tensor: the benchmark's reference.

Plain PyTorch, independent of the program under test.  From the same
tensor and the same initial factors it computes the sweeps that
``repro_torch.core.cpd.cpd_als`` documents: for each mode d in turn

    M_d  = MTTKRP(X, factors, d)          gather, Hadamard, index_add
    V    = Hadamard of the grams F_w^T F_w, w != d
    Y_d  = M_d (V + ridge I)^-1           ridge = 1e-10 max(trace(V)/R, 1)
    lam  = column norms of Y_d (1 where a norm is under 1e-12)
    F_d  = Y_d / lam,  weights = lam

and after each sweep the fit ``1 - ||X - X_hat|| / ||X||`` from
``||X - X_hat||^2 = ||X||^2 - 2 <X, X_hat> + lam^T (*_w G_w) lam``.

The reference runs in float64, where that identity loses nothing at the
nonzero counts measured (1e-16 of ||X||^2).  ``precision="tf32"`` is the
control: float32 arithmetic with every operand of every product rounded to
TF32's 10-bit mantissa first, as the card's TF32 tensor cores compute.
The nonzeros are taken in blocks, so a large tensor needs no more than one
block's (nnz, R) product at a time.
"""
from __future__ import annotations

import torch

RIDGE_REL = 1e-10
BLOCK_NNZ = 1 << 21


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10-bit mantissa,
    ties away from zero); infinities and NaNs pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    keep = (bits & 0x7F800000) == 0x7F800000
    return torch.where(keep, bits, rounded).view(torch.float32)


class Arithmetic:
    """The precision a reference runs in: its dtype and the rounding of
    each product's operands."""

    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return round_tf32(x) if self.precision == "tf32" else x

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)


def mttkrp(indices, values, factors, mode: int, ar: Arithmetic):
    """``(I_mode, R)``: sum over the nonzeros of ``value * prod_{w != mode}
    F_w[i_w]`` into row ``i_mode``."""
    rank = factors[0].shape[1]
    out = torch.zeros((factors[mode].shape[0], rank), dtype=ar.dtype,
                      device=values.device)
    for lo in range(0, values.shape[0], BLOCK_NNZ):
        idx = indices[lo:lo + BLOCK_NNZ]
        acc = ar.q(values[lo:lo + BLOCK_NNZ])[:, None]
        for w, F in enumerate(factors):
            if w != mode:
                acc = ar.q(acc) * ar.q(F.index_select(0, idx[:, w]))
        out.index_add_(0, idx[:, mode], acc)
    return out


def inner_product(indices, values, factors, weights, ar: Arithmetic):
    """``<X, X_hat>`` over the nonzeros, X_hat the weighted CP model."""
    total = torch.zeros((), dtype=ar.dtype, device=values.device)
    for lo in range(0, values.shape[0], BLOCK_NNZ):
        idx = indices[lo:lo + BLOCK_NNZ]
        acc = ar.q(factors[0].index_select(0, idx[:, 0]))
        for w in range(1, len(factors)):
            acc = ar.q(acc) * ar.q(factors[w].index_select(0, idx[:, w]))
        model = ar.matmul(acc, weights[:, None])[:, 0]
        total = total + (ar.q(values[lo:lo + BLOCK_NNZ]) * ar.q(model)).sum()
    return total


def hadamard(grams, exclude=None):
    V = torch.ones_like(grams[0])
    for w, G in enumerate(grams):
        if w != exclude:
            V = V * G
    return V


def solve(M, V, ar: Arithmetic):
    """``M (V + ridge I)^-1`` by Cholesky; LU where the factorization fails."""
    rank = V.shape[0]
    ridge = RIDGE_REL * torch.clamp(torch.trace(V) / rank, min=1.0)
    Vr = ar.q(V + ridge * torch.eye(rank, dtype=V.dtype, device=V.device))
    L, info = torch.linalg.cholesky_ex(Vr)
    if int(info) == 0:
        return torch.cholesky_solve(ar.q(M).T, L).T
    return torch.linalg.solve(Vr, ar.q(M).T).T


def cp_als(indices, values, shape, init_factors, n_sweeps: int, *,
           precision: str = "float64"):
    """``n_sweeps`` sweeps of CP-ALS from ``init_factors`` (weights 1).

    ``indices``: (nnz, N) integer tensor, ``values``: (nnz,), both on the
    device to run on.  Returns ``(factors, weights, fits)``: the
    column-normalized factors, the weights and one fit per sweep, in the
    arithmetic's dtype."""
    ar = Arithmetic(precision)
    dev = values.device
    indices = indices.to(device=dev, dtype=torch.long)
    values = values.to(ar.dtype)
    factors = [torch.as_tensor(F).to(device=dev, dtype=ar.dtype)
               for F in init_factors]
    if [F.shape[0] for F in factors] != list(shape):
        raise ValueError("initial factors do not match the tensor's shape")
    rank = factors[0].shape[1]
    grams = [ar.matmul(F.T, F) for F in factors]
    weights = torch.ones(rank, dtype=ar.dtype, device=dev)
    norm_x_sq = (values.double() ** 2).sum().to(ar.dtype)
    fits = []
    for _ in range(n_sweeps):
        for d in range(len(shape)):
            M = mttkrp(indices, values, factors, d, ar)
            Y = solve(M, hadamard(grams, exclude=d), ar)
            lam = torch.linalg.vector_norm(Y, dim=0)
            lam = torch.where(lam > 1e-12, lam, torch.ones_like(lam))
            factors[d] = Y / lam
            grams[d] = ar.matmul(factors[d].T, factors[d])
            weights = lam
        ip = inner_product(indices, values, factors, weights, ar)
        model_sq = ar.matmul(weights[None, :],
                             ar.matmul(hadamard(grams), weights[:, None]))[0, 0]
        resid_sq = torch.clamp(norm_x_sq - 2.0 * ip + model_sq, min=0.0)
        fits.append(1.0 - torch.sqrt(resid_sq) / torch.sqrt(norm_x_sq))
    return factors, weights, torch.stack(fits)
