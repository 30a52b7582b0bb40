"""Device-resident CPD-ALS (port of ``repro.core.als_device``, method "cp").

The whole N-mode sweep -- MTTKRP (slab / segment / coo backend), gram
updates, the ridge normal-equations solve, column normalization and the
sparse fit -- runs on the device with the state carried there.  A
``check_every`` window of sweeps is queued without any host read; the
host reads once per window (the last fit and a solve-health flag, in one
transfer) and once at the end.  ``CPDResult.host_syncs`` counts them.

The reference guards each solve with ``lax.cond(all finite)`` and a pinv
rescue.  Here the solve reports, on the device, whether its
factorization failed or gave a non-finite result; the flag rides along
with the window's fit read.  When it is set, the window is run again from
its starting state with the per-solve pinv rescue -- the same factors the
reference computes, and a rare path that may sync.

Window functions are cached per (backend, nmodes, rank, shapes, slab
tiling, solver, block length), as the reference caches its compiled
sweep blocks; ``sweep_cache_stats()`` exposes the hits and misses.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..convert import state_from_reference
from ..device import resolve_device
from ..kernels import ref as kref
from ..obs import clock as obs_clock
from .coo import SparseTensor
from .cpd import CPDResult
from .mttkrp import MTTKRPPlan, make_plan, slab_backend, unrelabel_rows

_RIDGE_REL = 1e-10


def resolve_solver(solver: str, device) -> str:
    """Resolve 'auto' to the per-device normal-equations solver, as the
    reference does per backend: 'cho' (Cholesky) off the CPU, 'inv' (LU
    inverse) on it."""
    if solver == "auto":
        solver = "cho" if torch.device(device).type != "cpu" else "inv"
    if solver not in ("cho", "inv"):
        raise ValueError(f"unknown solver {solver!r}")
    return solver


# ---------------------------------------------------------------------------
# MTTKRP substrate
# ---------------------------------------------------------------------------


def _build_one_mttkrp(backend: str, nmodes: int, shapes: tuple[int, ...],
                      slab_meta: tuple | None):
    """``one_mttkrp(d, mode_data, factors) -> (I_d, R)`` in original row
    order, with values baked into the mode data:

      slab:    (idx_packed, vals_packed, lrows_packed, rb_of, chunks, row_perm)
      segment: (idx, rows, vals, row_perm)
      coo:     (indices, values)
    """
    in_modes = [tuple(w for w in range(nmodes) if w != d)
                for d in range(nmodes)]

    def one_mttkrp(d, mode_data, factors):
        if backend == "slab":
            return slab_backend(mode_data, [factors[w] for w in in_modes[d]],
                                shapes[d], slab_meta[d])
        if backend == "segment":
            idx, rows, vals, row_perm = mode_data
            out = kref.mttkrp_sorted_segments(
                idx, rows, vals, [factors[w] for w in in_modes[d]], shapes[d])
            return unrelabel_rows(out, row_perm)
        if backend == "coo":
            indices, values = mode_data
            return kref.mttkrp_coo(indices, values, list(factors), d, shapes[d])
        raise ValueError(f"unknown backend {backend!r}")

    return one_mttkrp


def _hadamard_grams(grams, rank: int, exclude: int | None = None):
    V = torch.ones((rank, rank), dtype=torch.float32, device=grams[0].device)
    for w, g in enumerate(grams):
        if w != exclude:
            V = V * g
    return V


def _pinv(a):
    return torch.linalg.pinv(a, rtol=1e-10)


def _build_solver(rank: int, solver: str):
    """``solve(M, V) -> (Yd, ok, Vr)``: the ridge-regularized normal-equations
    solve.  ``ok`` is a 0-d bool tensor, False where the reference's
    ``lax.cond`` would take its pinv rescue (failed factorization or a
    non-finite result); computing it needs no host read."""

    def solve(M, V):
        eye = torch.eye(rank, dtype=torch.float32, device=V.device)
        ridge = _RIDGE_REL * torch.clamp(torch.trace(V) / rank, min=1.0)
        Vr = V + ridge * eye
        if solver == "cho":
            L, info = torch.linalg.cholesky_ex(Vr)
            Z = torch.linalg.solve_triangular(L, M.T, upper=False)
            Yd = torch.linalg.solve_triangular(L.T, Z, upper=True).T
        else:
            inv, info = torch.linalg.inv_ex(Vr)
            Yd = M @ inv
        ok = (info == 0) & torch.isfinite(Yd).all()
        return Yd, ok, Vr

    return solve


def normalize_columns(Yd):
    """Column-normalize, guarding dead columns; returns (Yd, lam)."""
    lam = torch.linalg.vector_norm(Yd, dim=0)
    lam = torch.where(lam > 1e-12, lam, 1.0)
    return Yd / lam, lam


def _build_sparse_fit(nmodes: int, rank: int):
    """On-device sparse fit: ``<X, X_hat>`` over the nnz plus the
    gram-product model norm; no dense reconstruction, no host read.
    ``fit_data = (index columns, values, norm_x_sq)``."""

    def sparse_fit(factors, grams, weights, fit_data):
        idx_cols, values, norm_x_sq = fit_data
        acc = factors[0].index_select(0, idx_cols[0])
        for d in range(1, nmodes):
            acc = acc * factors[d].index_select(0, idx_cols[d])
        ip = values @ (acc @ weights)
        V = _hadamard_grams(grams, rank)
        model_sq = weights @ V @ weights
        resid_sq = torch.clamp(norm_x_sq - 2.0 * ip + model_sq, min=0.0)
        return 1.0 - torch.sqrt(resid_sq) / torch.clamp(
            torch.sqrt(norm_x_sq), min=1e-12)

    return sparse_fit


# ---------------------------------------------------------------------------
# Sweep and window builders
# ---------------------------------------------------------------------------


def build_sweep_fn(backend: str, nmodes: int, rank: int,
                   shapes: tuple[int, ...], slab_meta: tuple | None,
                   solver: str):
    """One full sweep: ``sweep(state, mode_data_all, fit_data, rescue) ->
    (state, fit, ok)``.  The state is never updated in place, so a caller
    may keep the previous one.  ``rescue=True`` replaces a failed solve by
    ``M @ pinv(Vr)`` (that branch reads the flag on the host)."""
    one_mttkrp = _build_one_mttkrp(backend, nmodes, shapes, slab_meta)
    solve = _build_solver(rank, solver)
    sparse_fit = _build_sparse_fit(nmodes, rank)

    def sweep(state, mode_data_all, fit_data, rescue=False):
        factors, grams, weights = list(state[0]), list(state[1]), state[2]
        ok_all = None
        for d in range(nmodes):
            M = one_mttkrp(d, mode_data_all[d], factors)
            V = _hadamard_grams(grams, rank, exclude=d)
            Yd, ok, Vr = solve(M, V)
            if rescue and not bool(ok):
                Yd = M @ _pinv(Vr)
            ok_all = ok if ok_all is None else ok_all & ok
            Yd, lam = normalize_columns(Yd)
            factors[d] = Yd
            grams[d] = Yd.T @ Yd
            weights = lam
        fit = sparse_fit(factors, grams, weights, fit_data)
        return (tuple(factors), tuple(grams), weights), fit, ok_all

    return sweep


@functools.lru_cache(maxsize=None)
def _build_sweep_block(backend: str, nmodes: int, rank: int,
                       shapes: tuple[int, ...], slab_meta: tuple | None,
                       solver: str, block: int):
    """``run_block(state, mode_data_all, fit_data, rescue=False) ->
    (state, fits (block,), ok)``: ``block`` sweeps queued back to back with
    no host read."""
    sweep = build_sweep_fn(backend, nmodes, rank, shapes, slab_meta, solver)

    def run_block(state, mode_data_all, fit_data, rescue=False):
        fits, ok = [], None
        for _ in range(block):
            state, fit, ok_s = sweep(state, mode_data_all, fit_data, rescue)
            fits.append(fit)
            ok = ok_s if ok is None else ok & ok_s
        return state, torch.stack(fits), ok

    return run_block


def sweep_cache_stats():
    """(hits, misses, currsize) of the window-function cache."""
    info = _build_sweep_block.cache_info()
    return {"hits": info.hits, "misses": info.misses,
            "currsize": info.currsize}


def _collect_mode_data(plan: MTTKRPPlan, backend: str, rank: int):
    """Per-mode device arrays (cached on the plan) + static slab tiling."""
    N = plan.tensor.nmodes
    if backend == "segment":
        return tuple(plan.device_arrays(d) for d in range(N)), None
    if backend == "slab":
        datas, metas = [], []
        for d in range(N):
            packed = plan.packed(d)
            mp = plan.mode_plan(d, rank)    # core.plan decides rank_block
            datas.append(plan.device_packed(d))
            metas.append((packed.num_row_blocks, packed.block_rows,
                          packed.tile, mp.rank_block))
        return tuple(datas), tuple(metas)
    if backend == "coo":
        coo = plan.device_coo()
        return tuple(coo for _ in range(N)), None
    raise ValueError(f"unknown backend {backend!r}")


def init_state_host(tensor_shape, rank: int, seed: int):
    """Host-side (pure numpy) random init shared by every engine: same
    seed => same starting point for the host loop, the fused engine, and
    the batched engine.  Kept on host so the serving path can stack B of
    these and upload ONE array per state leaf instead of paying 2N+1 tiny
    transfers plus N gram matmul dispatches per tensor."""
    rng = np.random.default_rng(seed)
    factors = tuple(
        rng.standard_normal((I, rank)).astype(np.float32)
        for I in tensor_shape
    )
    grams = tuple(F.T @ F for F in factors)
    weights = np.ones((rank,), np.float32)
    return (factors, grams, weights)


def state_from_factors(factors, weights=None):
    """Host state tuple from explicit (e.g. previously fitted) factors.
    Grams are recomputed so the state is always self-consistent."""
    factors = tuple(np.asarray(F, dtype=np.float32) for F in factors)
    grams = tuple(F.T @ F for F in factors)
    rank = factors[0].shape[1]
    if weights is None:
        weights = np.ones((rank,), np.float32)
    return (factors, grams, np.asarray(weights, dtype=np.float32))


def make_fit_data(tensor: SparseTensor, device) -> tuple:
    """``(index columns, values, norm_x_sq)`` of the sparse fit on ``device``."""
    idx = torch.as_tensor(tensor.indices, device=device)
    return (
        tuple(idx[:, d].contiguous() for d in range(tensor.nmodes)),
        torch.as_tensor(tensor.values.astype(np.float32), device=device),
        torch.tensor(tensor.norm() ** 2, dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def cpd_als_fused(
    tensor: SparseTensor,
    rank: int,
    *,
    plan: MTTKRPPlan | None = None,
    kappa: int = 1,
    n_iters: int = 25,
    tol: float = 1e-5,
    seed: int = 0,
    backend: str = "slab",
    check_every: int = 1,
    solver: str = "auto",
    init_state: tuple | None = None,
    profile_mttkrp: bool = False,
    verbose: bool = False,
    device="cuda",
) -> CPDResult:
    """Device-resident CPD-ALS.  Same initialization and update order as
    the reference's ``cpd_als_fused``; each ``check_every``-iteration window
    is queued without a host read and the host syncs only at window
    boundaries.

    ``init_state`` (a host state tuple, e.g. from ``state_from_factors``)
    warm-starts instead of the seeded random init.  ``profile_mttkrp=True``
    replays the run's MTTKRPs alone afterwards (their launches count in
    the kernel's ``LAUNCHES``) so ``mttkrp_seconds`` is separable from
    solve time."""
    t_start = obs_clock.now()
    dev = resolve_device(device)
    N = tensor.nmodes
    check_every = max(1, int(check_every))
    host_state = (init_state if init_state is not None
                  else init_state_host(tensor.shape, rank, seed))
    state = state_from_reference(*host_state, device=dev)
    solver = resolve_solver(solver, dev)

    if plan is None and backend == "coo":
        # The coo backend needs no mode-specific layouts.
        coo = (torch.as_tensor(tensor.indices, device=dev),
               torch.as_tensor(tensor.values.astype(np.float32), device=dev))
        mode_data_all, slab_meta = tuple(coo for _ in range(N)), None
    else:
        if plan is None:
            plan = make_plan(tensor, kappa, device=dev)
        elif plan.device != dev:
            raise ValueError(f"plan lives on {plan.device}, run asked for {dev}")
        mode_data_all, slab_meta = _collect_mode_data(plan, backend, rank)
    fit_data = make_fit_data(tensor, dev)

    shapes = tuple(int(s) for s in tensor.shape)
    n_blocks, rem = divmod(n_iters, check_every)
    sweep_k = _build_sweep_block(backend, N, rank, shapes, slab_meta, solver,
                                 check_every) if n_blocks else None
    sweep_rem = _build_sweep_block(backend, N, rank, shapes, slab_meta, solver,
                                   rem) if rem else None

    fits_dev: list = []
    host_syncs = 0
    last_fit = -np.inf
    it = 0
    windows_run: list[int] = []
    for b in range(n_blocks + (1 if rem else 0)):
        k = check_every if b < n_blocks else rem
        fn = sweep_k if b < n_blocks else sweep_rem
        start = state
        state, fits_blk, ok = fn(start, mode_data_all, fit_data)
        # The only in-window host sync: the last fit and the solve flag.
        f, healthy = torch.stack([fits_blk[-1], ok.to(fits_blk.dtype)]).tolist()
        host_syncs += 1
        if not healthy:
            state, fits_blk, _ = fn(start, mode_data_all, fit_data, rescue=True)
            f = float(fits_blk[-1])
            host_syncs += 1
        fits_dev.append(fits_blk)
        windows_run.append(k)
        it += k
        if verbose:
            print(f"  ALS iter {it:3d}: fit={f:.6f} (cp/fused)")
        if abs(f - last_fit) < tol:
            break
        last_fit = f

    host_syncs += 1                             # final materialization
    fits = torch.cat(fits_dev).tolist() if fits_dev else []

    mttkrp_seconds = 0.0
    if profile_mttkrp and windows_run:
        mttkrp_seconds = _profile_mttkrp_replay(
            _build_one_mttkrp(backend, N, shapes, slab_meta), N, state[0],
            mode_data_all, sum(windows_run), dev)

    return CPDResult(
        factors=[F.cpu().numpy() for F in state[0]],
        weights=state[2].cpu().numpy().astype(np.float64),
        fits=fits,
        iters=it,
        mttkrp_seconds=mttkrp_seconds,
        total_seconds=obs_clock.now() - t_start,
        host_syncs=host_syncs,
        engine="fused",
    )


def _profile_mttkrp_replay(one_mttkrp, nmodes, factors, mode_data_all,
                           sweeps: int, device) -> float:
    """Wall time of ``sweeps`` MTTKRP-only sweeps (one warm-up sweep first;
    the kernel's cost does not depend on factor values, so replaying with
    the final factors is faithful)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for d in range(nmodes):
        one_mttkrp(d, mode_data_all[d], factors)
    sync()
    t0 = obs_clock.now()
    for _ in range(sweeps):
        for d in range(nmodes):
            one_mttkrp(d, mode_data_all[d], factors)
    sync()
    return obs_clock.now() - t0
