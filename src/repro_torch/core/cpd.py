"""CPD-ALS (Canonical Polyadic Decomposition via Alternating Least Squares).

For each mode d:
  M_d   = MTTKRP(X, factors, d)                      (the bottleneck)
  V     = hadamard_{w != d} (Y_w^T Y_w)              (R x R grams)
  Y_d   = M_d @ pinv(V)
  lambda= column norms; Y_d normalized
iterated until the fit converges.  The fit is computed sparsely:
  ||X - X_hat||^2 = ||X||^2 - 2<X, X_hat> + ||X_hat||^2
with no dense reconstruction.

``engine="fused"`` (default) runs the device-resident engine in
``als_device``; ``engine="host"`` keeps the per-mode host loop of the
reference (numpy float64 solve) for comparison.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..obs import clock as obs_clock
from ..obs import trace as obs_trace
from .coo import SparseTensor
from .mttkrp import MTTKRPPlan, make_plan, mttkrp


@dataclasses.dataclass
class CPDResult:
    factors: list[np.ndarray]     # column-normalized
    weights: np.ndarray           # (R,) lambda
    fits: list[float]             # fit per iteration (1 - relerr)
    iters: int
    mttkrp_seconds: float         # time in the bottleneck kernel
    total_seconds: float
    host_syncs: int = 0           # device->host synchronizations performed
    engine: str = "host"          # which ALS engine produced this result
    method: str = "cp"
    h2d_bytes: int = 0            # bytes the fused call uploaded
    graph_sweeps: int = 0         # sweeps replayed from captured CUDA graphs

    def reconstruct_at(self, indices: np.ndarray) -> np.ndarray:
        acc = np.ones((indices.shape[0], len(self.weights)))
        for d, F in enumerate(self.factors):
            acc = acc * F[indices[:, d]]
        return acc @ self.weights


def _innerprod_sparse(tensor: SparseTensor, factors, weights) -> float:
    acc = np.ones((tensor.nnz, len(weights)))
    for d, F in enumerate(factors):
        acc = acc * np.asarray(F)[tensor.indices[:, d]]
    return float(tensor.values @ (acc @ np.asarray(weights)))


def _model_norm_sq(factors, weights) -> float:
    R = len(weights)
    V = np.ones((R, R))
    for F in factors:
        F = np.asarray(F, dtype=np.float64)
        V = V * (F.T @ F)
    w = np.asarray(weights, dtype=np.float64)
    return float(w @ V @ w)


def cpd_als(
    tensor: SparseTensor,
    rank: int,
    *,
    plan: MTTKRPPlan | None = None,
    kappa: int = 1,
    n_iters: int = 25,
    tol: float = 1e-5,
    seed: int = 0,
    backend: str = "slab",
    engine: str = "fused",
    check_every: int = 1,
    method: str = "cp",
    init_state: tuple | None = None,
    weights: np.ndarray | None = None,
    verbose: bool = False,
    device="cuda",
) -> CPDResult:
    """Run CPD-ALS on ``device`` (default ``"cuda"``; raises without it).

    ``engine="fused"`` delegates to ``als_device.cpd_als_fused``: factors
    stay on the device and the host syncs once per ``check_every`` window.
    ``engine="host"`` is the per-mode host loop (plain CP only).
    ``method`` selects the decomposition method from
    ``repro_torch.methods`` ('cp', 'nncp', 'masked').  ``init_state`` (a
    host state tuple, see ``als_device.init_state_host``) warm-starts the
    fused engine.  ``weights`` -- per-entry observation weights in
    canonical COO order for weighted-fit methods ('masked'): fractional
    confidences, weight 0 = the entry is treated as unobserved."""
    if engine not in ("fused", "host"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "host" and (method != "cp" or init_state is not None
                             or weights is not None):
        raise ValueError(
            "engine='host' supports only method='cp' with random init; "
            "methods, warm starts and entry weights run on the fused engine")
    dev = resolve_device(device)
    tr = obs_trace.sink()
    with (obs_trace.NULL if tr is None else
          tr.span("cpd.call", cat="cpd", engine=engine, method=method,
                  backend=backend, n_iters=n_iters,
                  check_every=check_every)):
        if engine == "fused":
            from .als_device import cpd_als_fused

            return cpd_als_fused(
                tensor, rank, plan=plan, kappa=kappa, n_iters=n_iters,
                tol=tol, seed=seed, backend=backend, check_every=check_every,
                method=method, init_state=init_state, weights=weights,
                verbose=verbose, device=dev,
            )
        return _cpd_als_host(tensor, rank, plan, kappa, n_iters, tol, seed,
                             backend, verbose, dev)


def _cpd_als_host(tensor, rank, plan, kappa, n_iters, tol, seed, backend,
                  verbose, dev) -> CPDResult:
    """``engine="host"``: the reference's per-mode host loop."""
    t_start = obs_clock.now()
    rng = np.random.default_rng(seed)
    N = tensor.nmodes
    if plan is None:
        plan = make_plan(tensor, kappa, device=dev)
    host_f = [rng.standard_normal((I, rank)).astype(np.float32)
              for I in tensor.shape]
    factors = [torch.as_tensor(F, device=dev) for F in host_f]
    weights = np.ones(rank, dtype=np.float64)
    norm_x_sq = tensor.norm() ** 2
    fits: list[float] = []
    mttkrp_t = 0.0
    host_syncs = 0
    last_fit = -np.inf

    grams = [np.asarray(F, np.float64).T @ np.asarray(F, np.float64)
             for F in host_f]

    it = 0
    for it in range(1, n_iters + 1):
        for d in range(N):
            t0 = obs_clock.now()
            M = mttkrp(plan, factors, d, backend=backend)
            M = M.cpu().numpy().astype(np.float64)
            host_syncs += 1
            mttkrp_t += obs_clock.now() - t0

            V = np.ones((rank, rank))
            for w in range(N):
                if w != d:
                    V = V * grams[w]
            ridge = 1e-10 * max(np.trace(V) / rank, 1.0)
            Vr = V + ridge * np.eye(rank)
            try:
                Yd = np.linalg.solve(Vr.T, M.T).T
            except np.linalg.LinAlgError:
                Yd = M @ np.linalg.pinv(Vr, rcond=1e-10)
            lam = np.linalg.norm(Yd, axis=0)
            lam = np.where(lam > 1e-12, lam, 1.0)
            Yd = Yd / lam
            weights = lam
            host_f[d] = Yd.astype(np.float32)
            factors[d] = torch.as_tensor(host_f[d], device=dev)
            grams[d] = Yd.T @ Yd

        ip = _innerprod_sparse(tensor, host_f, weights)
        model_sq = _model_norm_sq(host_f, weights)
        host_syncs += N            # the reference pulls N factors for the fit
        resid_sq = max(norm_x_sq - 2.0 * ip + model_sq, 0.0)
        fit = 1.0 - np.sqrt(resid_sq) / max(np.sqrt(norm_x_sq), 1e-12)
        fits.append(float(fit))
        if verbose:
            print(f"  ALS iter {it:3d}: fit={fit:.6f}")
        if abs(fit - last_fit) < tol:
            break
        last_fit = fit

    return CPDResult(
        factors=[np.asarray(F) for F in host_f],
        weights=np.asarray(weights),
        fits=fits,
        iters=it,
        mttkrp_seconds=mttkrp_t,
        total_seconds=obs_clock.now() - t_start,
        host_syncs=host_syncs,
        engine="host",
    )
