"""Plain PyTorch / numpy oracles for spMTTKRP (port of ``repro.kernels.ref``).

  * ``mttkrp_dense``  -- numpy, literal Eq.(1): X_(d) @ KRP(factors).
                         Only for tiny test tensors.
  * ``mttkrp_coo``    -- torch, elementwise COO formulation with a
                         materialized (nnz, R) Khatri-Rao intermediate and
                         ``index_add_``: the ``coo`` backend.
  * ``mttkrp_sorted_segments`` -- torch, the layout-aware formulation the
                         slab kernel implements: the ``segment`` backend.
  * ``cp_model_at_coords`` / ``mttkrp_masked_residual`` -- the CP model at
                         sparse coordinates, and the masked method's
                         MTTKRP of the EM-filled tensor.

``segment_sum`` of the reference becomes ``index_add_``; both accumulate
in float32.
"""
from __future__ import annotations

import numpy as np
import torch


def khatri_rao(mats: list[np.ndarray]) -> np.ndarray:
    """Column-wise Khatri-Rao product, row-major sweep (lowest mode fastest
    to match ``SparseTensor.matricize`` column ordering)."""
    out = mats[0]
    for m in mats[1:]:
        # (I, R) x (J, R) -> (I*J, R) with J varying fastest.
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out


def mttkrp_dense(tensor, factors: list[np.ndarray], mode: int) -> np.ndarray:
    """Numpy dense oracle: X_(d) @ (KRP of input factors)."""
    others = [factors[w] for w in range(len(factors)) if w != mode]
    return tensor.matricize(mode) @ khatri_rao(others)


def _hadamard_rows(values, indices, factors) -> torch.Tensor:
    acc = values.to(torch.float32)[:, None]
    for w, fac in enumerate(factors):
        acc = acc * fac.index_select(0, indices[:, w].long()).to(torch.float32)
    return acc


def mttkrp_coo(
    indices: torch.Tensor,        # (nnz, N) int32
    values: torch.Tensor,         # (nnz,)
    factors: list[torch.Tensor],  # N factor matrices (I_d, R)
    mode: int,
    num_rows: int,
) -> torch.Tensor:
    """Elementwise COO MTTKRP (unsorted; materializes the (nnz, R) Hadamard
    intermediate the paper's fused kernel avoids)."""
    others = [w for w in range(len(factors)) if w != mode]
    acc = _hadamard_rows(values, indices[:, others],
                         [factors[w] for w in others])
    out = torch.zeros((num_rows, acc.shape[1]), dtype=torch.float32,
                      device=acc.device)
    return out.index_add_(0, indices[:, mode].long(), acc)


def cp_model_at_coords(
    indices: torch.Tensor,        # (nnz, N) int32 canonical COO coordinates
    factors: list[torch.Tensor],  # N factor matrices (I_d, R)
    weights: torch.Tensor,        # (R,)
) -> torch.Tensor:
    """CP model values at sparse coordinates: sum_r w_r * prod_d Y_d[i_d, r].

    The rank sum is an elementwise product and a row sum rather than a
    matrix-vector product: a BLAS gemv may sum a row in an order that
    depends on the number of rows, and the masked method needs each
    entry's value to be independent of which other entries are present
    (weight-0 == absent)."""
    acc = factors[0].index_select(0, indices[:, 0].long()).to(torch.float32)
    for d in range(1, len(factors)):
        acc = acc * factors[d].index_select(0, indices[:, d].long()).to(torch.float32)
    return (acc * weights.to(torch.float32)).sum(-1)


def mttkrp_masked_residual(
    indices: torch.Tensor,        # (nnz, N) int32 observed coordinates
    values: torch.Tensor,         # (nnz,) observed values
    entry_weights: torch.Tensor,  # (nnz,) observation weights (0 = missing)
    factors: list[torch.Tensor],  # N factor matrices (I_d, R)
    weights: torch.Tensor,        # (R,) lambda
    mode: int,
    num_rows: int,
) -> torch.Tensor:
    """Mask-weighted MTTKRP of the EM-filled tensor ``Xf = model + W * (X -
    model)``: the spMTTKRP of the residuals ``w_e * (x_e - model_e)`` over
    the observed coordinates plus the closed form of the dense model term,
    ``(Y_d * lambda) @ hadamard_{w != d}(Y_w^T Y_w)``.  Zero-weight entries
    add exactly +-0.0."""
    resid = entry_weights.to(torch.float32) * (
        values.to(torch.float32) - cp_model_at_coords(indices, factors, weights))
    sparse = mttkrp_coo(indices, resid, factors, mode, num_rows)
    rank = weights.shape[0]
    V = torch.ones((rank, rank), dtype=torch.float32, device=resid.device)
    for w, fac in enumerate(factors):
        if w != mode:
            fac = fac.to(torch.float32)
            V = V * (fac.T @ fac)
    dense = (factors[mode].to(torch.float32)
             * weights[None, :].to(torch.float32)) @ V
    return sparse + dense


def mttkrp_sorted_segments(
    input_indices: torch.Tensor,  # (nnz, W) int32, input-mode columns only
    rows: torch.Tensor,           # (nnz,) int32 relabeled output rows, sorted
    values: torch.Tensor,         # (nnz,)
    factors: list[torch.Tensor],  # W input factor matrices (I_w, R)
    num_rows: int,
) -> torch.Tensor:
    """Layout-aware oracle: same math as the slab kernel, float32 accumulate."""
    acc = _hadamard_rows(values, input_indices, factors)
    out = torch.zeros((num_rows, acc.shape[1]), dtype=torch.float32,
                      device=acc.device)
    return out.index_add_(0, rows.long(), acc)
