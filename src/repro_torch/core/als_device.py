"""Device-resident CPD-ALS (port of ``repro.core.als_device``).

The whole N-mode sweep -- MTTKRP (slab / segment / coo backend), the
method's per-mode update (for CP: gram Hadamard, the ridge
normal-equations solve, column normalization) and the fit -- runs on the
device with the state carried there.  A ``check_every`` window of sweeps
is queued without any host read; the host reads once per window (the
last fit and a solve-health flag, in one transfer) and once at the end.
``CPDResult.host_syncs`` counts them.

The reference guards each solve with ``lax.cond(all finite)`` and a pinv
rescue.  Here the solve reports, on the device, whether its
factorization failed or gave a non-finite result; the flag rides along
with the window's fit read.  When it is set, the window is run again from
its starting state with the per-solve pinv rescue -- the same factors the
reference computes, and a rare path that may sync.

Decomposition methods.  The substrate is method-agnostic: a method
(``repro_torch.methods``) supplies the per-mode update rule and, for the
masked method, the per-sweep values its MTTKRP runs on; everything else
-- the MTTKRP backends, the window, the fit, the caches -- is shared.
The sweep is written over *lanes*: a list of independent states, each
with its own fit data.  The fused engine runs one lane.  The batched
service (``repro_torch.serve``) runs B lanes in lockstep: per mode one
MTTKRP for all lanes (one launch of the batched kernel on the slab
backend), then each lane's update on its own tensors.  Every lane
therefore computes exactly what the one-lane sweep computes on its data,
whatever B is.  (The reference gets the same from ``jax.vmap``; in
PyTorch a batched matmul or reduction may pick another kernel, and so
another summation order, for another B.)

Window functions are cached per (backend, nmodes, rank, shapes, slab
tiling, solver, block length, method), as the reference caches its
compiled sweep blocks; ``sweep_cache_stats()`` exposes the hits and
misses.  Each build registers in the build ledger (``obs.ledger.LEDGER``,
kind ``sweep_block``; the MTTKRP-only replay as ``mttkrp_block``), and
``sweep_trace_stats()`` is the ledger's view of the sweep blocks: the
port's counterpart of the reference's trace counts, where a build takes
the place of an XLA trace.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..convert import state_from_reference
from ..device import resolve_device
from ..kernels import ref as kref
from ..kernels.mttkrp_slab import (mttkrp_slab_batched, mttkrp_slab_valued,
                                   scatter_slab_values)
from ..obs import clock as obs_clock
from ..obs import trace as obs_trace
from ..obs.ledger import LEDGER
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


def _build_valued_mttkrp(backend: str, nmodes: int, shapes: tuple[int, ...],
                         slab_meta: tuple | None):
    """``mttkrp_valued(d, mode_data, factors, vals) -> (I_d, R)``: the
    valued entry.  Mode data carries only the structural layout arrays; a
    fresh canonical-order value vector (the masked method's per-sweep
    residual) runs through the same kernels:

      slab:    (idx_packed, lrows_packed, rb_of, chunks, row_perm, perm,
                val_scatter)            vals[perm] scattered into the slabs
      segment: (idx, rows, row_perm, perm)     vals_layout = vals[perm]
      coo:     (indices,)                      canonical order already
    """
    in_modes = [tuple(w for w in range(nmodes) if w != d)
                for d in range(nmodes)]

    def mttkrp_valued(d, mode_data, factors, vals):
        if backend == "slab":
            idxp, lrowsp, rb_of, chunks, row_perm, perm, scatter = mode_data
            nrb, br, tile, rblk = slab_meta[d]
            out = mttkrp_slab_valued(
                idxp, vals[perm], scatter, lrowsp, rb_of,
                [factors[w] for w in in_modes[d]], chunks=chunks,
                num_row_blocks=nrb, block_rows=br, tile=tile,
                rank_block=rblk)[:shapes[d]]
            return unrelabel_rows(out, row_perm)
        if backend == "segment":
            idx, rows, row_perm, perm = mode_data
            out = kref.mttkrp_sorted_segments(
                idx, rows, vals[perm], [factors[w] for w in in_modes[d]],
                shapes[d])
            return unrelabel_rows(out, row_perm)
        if backend == "coo":
            (indices,) = mode_data
            return kref.mttkrp_coo(indices, vals, list(factors), d, shapes[d])
        raise ValueError(f"unknown backend {backend!r}")

    return mttkrp_valued


def _build_lane_mttkrp(backend: str, nmodes: int, shapes: tuple[int, ...],
                       slab_meta: tuple | None, valued: bool, batched: bool):
    """``mttkrp_lanes(d, mode_data, factor_lanes, value_lanes) -> [M per
    lane]`` (``value_lanes`` is None unless ``valued``).

    One lane (``batched=False``): mode data as ``_collect_mode_data`` or
    ``collect_structural_mode_data`` give it.  A batch of lanes: on the
    slab backend, the bucket-mates' packings stacked along a leading lane
    dimension (``serve.batched_engine``) and ONE launch of the batched
    kernel; the other backends take a list of per-lane mode data and run
    each lane's MTTKRP in turn."""
    single = (_build_valued_mttkrp if valued else _build_one_mttkrp)(
        backend, nmodes, shapes, slab_meta)
    if not batched:
        def one_lane(d, mode_data, factor_lanes, value_lanes):
            if valued:
                return [single(d, mode_data, factor_lanes[0], value_lanes[0])]
            return [single(d, mode_data, factor_lanes[0])]
        return one_lane
    if backend != "slab":
        def lane_by_lane(d, mode_data, factor_lanes, value_lanes):
            if valued:
                return [single(d, md, F, v) for md, F, v in
                        zip(mode_data, factor_lanes, value_lanes)]
            return [single(d, md, F) for md, F in zip(mode_data, factor_lanes)]
        return lane_by_lane
    in_modes = [tuple(w for w in range(nmodes) if w != d)
                for d in range(nmodes)]

    def slab_batched(d, mode_data, factor_lanes, value_lanes):
        nrb, br, tile, rblk = slab_meta[d]
        if valued:
            idxp, lrowsp, rb_of, chunks, row_perms, perm, scatter = mode_data
            vals = torch.stack(value_lanes).gather(1, perm)
            valsp = scatter_slab_values(vals, scatter, int(idxp.shape[-1]))
        else:
            idxp, valsp, lrowsp, rb_of, chunks, row_perms = mode_data
        in_f = [torch.stack([F[w] for F in factor_lanes]) for w in in_modes[d]]
        out = mttkrp_slab_batched(idxp, valsp, lrowsp, rb_of, in_f,
                                  chunks=chunks, num_row_blocks=nrb,
                                  block_rows=br, tile=tile, rank_block=rblk)
        return [unrelabel_rows(out[b, :shapes[d]], row_perms[b])
                for b in range(len(factor_lanes))]

    return slab_batched


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


def _solve_with_rescue(solve):
    """``solve(M, V, rescue=False) -> (Yd, ok)``.  ``rescue=True`` replaces
    a failed solve by ``M @ pinv(Vr)`` (that branch reads the flag on the
    host)."""

    def solve_rescued(M, V, rescue=False):
        Yd, ok, Vr = solve(M, V)
        if rescue and not bool(ok):
            Yd = M @ _pinv(Vr)
        return Yd, ok

    return solve_rescued


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


def _build_weighted_fit(nmodes: int, rank: int):
    """Observed-only weighted fit of the masked method:
    ``1 - sqrt(sum_e w_e (x_e - model_e)^2) / sqrt(sum_e w_e x_e^2)``.
    ``fit_data = (indices, values, entry_weights, weighted_norm_sq)``;
    weight-0 entries (nnz padding, or entries the caller masked out) add
    exactly +0.0.  ``grams`` is unused; the signature is the sparse fit's."""

    def weighted_fit(factors, grams, weights, fit_data):
        indices, values, ew, norm_x_sq = fit_data
        resid = values - kref.cp_model_at_coords(indices, factors, weights)
        resid_sq = torch.sum(ew * resid * resid)
        return 1.0 - torch.sqrt(resid_sq) / torch.clamp(
            torch.sqrt(norm_x_sq), min=1e-12)

    return weighted_fit


def validate_entry_weights(nnz: int, weights) -> np.ndarray:
    """A front-door per-entry weight vector as (nnz,) float32, finite and
    nonnegative; raises otherwise."""
    w = np.asarray(weights, dtype=np.float32).reshape(-1)
    if w.shape[0] != nnz:
        raise ValueError(
            f"entry weights must align with the nnz list: got {w.shape[0]} "
            f"weights for {nnz} nonzeros")
    if not np.all(np.isfinite(w)):
        raise ValueError("entry weights must be finite")
    if w.size and float(w.min()) < 0.0:
        raise ValueError("entry weights must be nonnegative")
    return w


def normalize_entry_weights(w: np.ndarray) -> np.ndarray:
    """Divide by ``max(1, w.max())``: the masked method's EM update is a
    majorizer only for weights in [0, 1], and the weighted objective (its
    argmin and its fit) does not change when the whole vector is scaled.
    Vectors already in [0, 1] pass through untouched; the map is
    idempotent."""
    m = float(w.max()) if w.size else 0.0
    return (w / np.float32(m)).astype(np.float32) if m > 1.0 else w


@dataclasses.dataclass(frozen=True)
class SweepContext:
    """What a decomposition method's update rule may use: the shared solve
    (ridge, on-device failure flag, pinv rescue), column normalization,
    the gram Hadamard and the two fits.  A method's ``update(ctx, d, M,
    factors, grams, weights, rescue) -> (Yd, lam, ok)`` and
    ``mttkrp_values(ctx, factors, weights, fit_data)`` receive it; the
    MTTKRP between them (``one_mttkrp`` / ``mttkrp_valued``) is run by the
    sweep, for one lane or a batch."""

    nmodes: int
    rank: int
    shapes: tuple[int, ...]
    one_mttkrp: Callable      # lanes: (d, mode_data, factor_lanes, None)
    mttkrp_valued: Callable   # lanes: (d, mode_data, factor_lanes, value_lanes)
    solve: Callable           # (M, V, rescue=False) -> (Yd, ok)
    normalize: Callable       # (Yd) -> (Yd, lam)
    sparse_fit: Callable      # (factors, grams, weights, fit_data) -> fit
    weighted_fit: Callable    # same signature, masked fit data
    hadamard: Callable        # (grams, exclude=None) -> (R, R)


def make_sweep_context(backend: str, nmodes: int, rank: int,
                       shapes: tuple[int, ...], slab_meta: tuple | None,
                       solver: str, valued: bool = False,
                       batched: bool = False) -> SweepContext:
    """The context a sweep hands its method: the lane MTTKRP of the
    value-baked (``valued=False``) or valued entry, for one lane or a
    batch, and the shared solve, normalization, Hadamard and fits."""
    lane_mttkrp = _build_lane_mttkrp(backend, nmodes, shapes, slab_meta,
                                     valued, batched)
    return SweepContext(
        nmodes=nmodes, rank=rank, shapes=shapes,
        one_mttkrp=None if valued else lane_mttkrp,
        mttkrp_valued=lane_mttkrp if valued else None,
        solve=_solve_with_rescue(_build_solver(rank, solver)),
        normalize=normalize_columns,
        sparse_fit=_build_sparse_fit(nmodes, rank),
        weighted_fit=_build_weighted_fit(nmodes, rank),
        hadamard=functools.partial(_hadamard_grams, rank=rank),
    )


def cp_update(ctx: SweepContext, d, M, factors, grams, weights, rescue):
    """Unconstrained CP's mode update: ridge normal equations, then column
    normalization.  ``ok`` is the solve's on-device health flag."""
    V = ctx.hadamard(grams, exclude=d)
    Yd, ok = ctx.solve(M, V, rescue)
    Yd, lam = ctx.normalize(Yd)
    return Yd, lam, ok


def _method_spec(method: str):
    """The registry entry of ``method`` (None for the inline CP path);
    raises for a stateful method, which has no sweep."""
    if method == "cp":
        return None
    from ..methods import get_method   # lazy: core imports without methods

    spec = get_method(method)
    if spec.stateful:
        raise ValueError(
            f"method {method!r} is stateful; it drives the substrate through "
            f"its own session API")
    return spec


# ---------------------------------------------------------------------------
# Sweep and window builders
# ---------------------------------------------------------------------------


def build_lane_sweep(backend: str, nmodes: int, rank: int,
                     shapes: tuple[int, ...], slab_meta: tuple | None,
                     solver: str, method: str = "cp", batched: bool = False):
    """One full sweep over lanes: ``sweep(states, mode_data_all, fit_data,
    rescue=False) -> (states, fits, oks)``, one entry per lane in each
    list.  ``mode_data_all`` is one lane's (``batched=False``) or the
    batch's (see ``_build_lane_mttkrp``); ``fit_data`` has one entry per
    lane.  ``oks[b]`` is lane b's on-device solve flag (None for a method
    without a solve).  No state is updated in place, so a caller may keep
    the previous one."""
    spec = _method_spec(method)
    valued = spec is not None and spec.valued_mode_data
    ctx = make_sweep_context(backend, nmodes, rank, shapes, slab_meta, solver,
                             valued, batched)
    update = spec.update if spec is not None and spec.update else cp_update
    values_for = spec.mttkrp_values if valued else None
    mttkrp = ctx.mttkrp_valued if valued else ctx.one_mttkrp
    fit_fn = (ctx.weighted_fit if spec is not None and spec.weighted_fit
              else ctx.sparse_fit)

    def sweep(states, mode_data_all, fit_data, rescue=False):
        factors = [list(st[0]) for st in states]
        grams = [list(st[1]) for st in states]
        weights = [st[2] for st in states]
        oks = [[] for _ in states]
        for d in range(nmodes):
            vals = None
            if valued:
                vals = [values_for(ctx, F, w, fd)
                        for F, w, fd in zip(factors, weights, fit_data)]
            Ms = mttkrp(d, mode_data_all[d], factors, vals)
            for b, M in enumerate(Ms):
                Yd, lam, ok = update(ctx, d, M, factors[b], grams[b],
                                     weights[b], rescue)
                factors[b][d] = Yd
                grams[b][d] = Yd.T @ Yd
                weights[b] = lam
                if ok is not None:
                    oks[b].append(ok)
        fits = [fit_fn(F, G, w, fd)
                for F, G, w, fd in zip(factors, grams, weights, fit_data)]
        states = [(tuple(F), tuple(G), w)
                  for F, G, w in zip(factors, grams, weights)]
        return states, fits, [torch.stack(o).all() if o else None for o in oks]

    return sweep


def build_sweep_fn(backend: str, nmodes: int, rank: int,
                   shapes: tuple[int, ...], slab_meta: tuple | None,
                   solver: str, method: str = "cp"):
    """One full sweep of one tensor: ``sweep(state, mode_data_all,
    fit_data, rescue=False) -> (state, fit, ok)``, the one-lane case of
    ``build_lane_sweep``.  ``rescue=True`` replaces a failed solve by
    ``M @ pinv(Vr)``."""
    lanes = build_lane_sweep(backend, nmodes, rank, shapes, slab_meta,
                             solver, method)

    def sweep(state, mode_data_all, fit_data, rescue=False):
        states, fits, oks = lanes([state], mode_data_all, [fit_data], rescue)
        return states[0], fits[0], oks[0]

    return sweep


@functools.lru_cache(maxsize=None)
def _build_sweep_block(backend: str, nmodes: int, rank: int,
                       shapes: tuple[int, ...], slab_meta: tuple | None,
                       solver: str, block: int, method: str = "cp"):
    """``run_block(state, mode_data_all, fit_data, rescue=False) ->
    (state, fits (block,), ok)``: ``block`` sweeps queued back to back with
    no host read.  ``ok`` is None for a method without a solve."""
    sweep = build_sweep_fn(backend, nmodes, rank, shapes, slab_meta, solver,
                           method)

    def run_block(state, mode_data_all, fit_data, rescue=False):
        fits, ok = [], None
        for _ in range(block):
            state, fit, ok_s = sweep(state, mode_data_all, fit_data, rescue)
            fits.append(fit)
            if ok_s is not None:
                ok = ok_s if ok is None else ok & ok_s
        return state, torch.stack(fits), ok

    return LEDGER.register(
        "sweep_block",
        (backend, nmodes, rank, shapes, slab_meta, solver, "block", block,
         "method", method),
        run_block)


@functools.lru_cache(maxsize=None)
def _build_mttkrp_block(backend: str, nmodes: int, rank: int,
                        shapes: tuple[int, ...], slab_meta: tuple | None,
                        block: int):
    """``run(factors, mode_data_all)``: ``block`` sweeps of the N mode
    MTTKRPs with no solve, normalization or fit, queued with no host
    read.  Timing it against the full sweep separates ``mttkrp_seconds``
    (the kernel's cost does not depend on factor values, so replaying
    with the final factors is faithful)."""
    one_mttkrp = _build_one_mttkrp(backend, nmodes, shapes, slab_meta)

    def run(factors, mode_data_all):
        for _ in range(block):
            for d in range(nmodes):
                one_mttkrp(d, mode_data_all[d], factors)

    return LEDGER.register(
        "mttkrp_block",
        (backend, nmodes, rank, shapes, slab_meta, "block", block), run)


def sweep_cache_stats():
    """(hits, misses, currsize) of the window-function cache."""
    info = _build_sweep_block.cache_info()
    return {"hits": info.hits, "misses": info.misses,
            "currsize": info.currsize}


def sweep_trace_stats():
    """``{"blocks", "traces"}`` of the sweep blocks, a view over
    ``obs.ledger.LEDGER`` (kind ``sweep_block``): blocks registered, and
    builds since the ledger's last ``reset()``.  A repeated same-shape
    decomposition, or a streaming increment inside its bucket, leaves
    ``traces`` unchanged; a novel shape or window length adds one per
    new block.  Agrees with ``sweep_cache_stats()["misses"]`` deltas."""
    s = LEDGER.stats("sweep_block")
    return {"blocks": s["blocks"], "traces": s["traces"]}


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


def collect_structural_mode_data(plan: MTTKRPPlan, backend: str, rank: int):
    """Mode data for the valued MTTKRP (see ``_build_valued_mttkrp``):
    structural layout arrays plus the canonical->layout permutation (and
    the layout->slab scatter for slab), no baked values.  The masked
    method collects through here."""
    N = plan.tensor.nmodes
    if backend == "slab":
        metas = []
        for d in range(N):
            packed = plan.packed(d)
            metas.append((packed.num_row_blocks, packed.block_rows,
                          packed.tile, plan.mode_plan(d, rank).rank_block))
        return (tuple(plan.device_structural(d, backend) for d in range(N)),
                tuple(metas))
    if backend == "segment":
        return tuple(plan.device_structural(d, backend) for d in range(N)), None
    if backend == "coo":
        return tuple((plan.device_coo()[0],) for _ in range(N)), None
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


def init_state(tensor_shape, rank: int, seed: int, device="cuda"):
    """Device-resident seeded init for the sequential fused engine: the
    host init (``init_state_host``) uploaded to ``device``."""
    return state_from_reference(*init_state_host(tensor_shape, rank, seed),
                                device=resolve_device(device))


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
    method: str = "cp",
    init_state: tuple | None = None,
    weights: np.ndarray | None = None,
    profile_mttkrp: bool = False,
    verbose: bool = False,
    device="cuda",
) -> CPDResult:
    """Device-resident CPD-ALS.  Same initialization and update order as
    the reference's ``cpd_als_fused``; each ``check_every``-iteration window
    is queued without a host read and the host syncs only at window
    boundaries.

    ``method`` selects the update rule from ``repro_torch.methods``
    ('cp', 'nncp', 'masked').  ``weights`` -- per-entry observation
    weights in canonical COO order, for weighted-fit methods ('masked')
    only: validated, then divided by ``max(1, w.max())``.  ``init_state``
    (a host state tuple, e.g. from ``state_from_factors``) warm-starts
    instead of the method's seeded init.  ``profile_mttkrp=True`` replays
    the run's MTTKRPs alone afterwards (their launches count in the
    kernel's ``LAUNCHES``) so ``mttkrp_seconds`` is separable from the
    rest; it covers value-baked mode data only (not 'masked')."""
    t_start = obs_clock.now()
    dev = resolve_device(device)
    N = tensor.nmodes
    check_every = max(1, int(check_every))
    spec = _method_spec(method)
    if weights is not None:
        if spec is None or not spec.weighted_fit:
            raise ValueError(
                f"per-entry weights require a weighted-fit method "
                f"(e.g. 'masked'), got method={method!r}")
        weights = normalize_entry_weights(
            validate_entry_weights(tensor.nnz, weights))
    if init_state is not None:
        host_state = init_state
    elif spec is not None and spec.init_state_host is not None:
        host_state = spec.init_state_host(tensor.shape, rank, seed)
    else:
        host_state = init_state_host(tensor.shape, rank, seed)
    state = state_from_reference(*host_state, device=dev)
    solver = resolve_solver(solver, dev)

    structural = spec is not None and spec.valued_mode_data
    if plan is None and backend == "coo":
        # The coo backend needs no mode-specific layouts.
        idx = torch.as_tensor(tensor.indices, device=dev)
        coo = ((idx,) if structural else
               (idx, torch.as_tensor(tensor.values.astype(np.float32), device=dev)))
        mode_data_all, slab_meta = tuple(coo for _ in range(N)), None
    else:
        if plan is None:
            plan = make_plan(tensor, kappa, device=dev)
        elif plan.device != dev:
            raise ValueError(f"plan lives on {plan.device}, run asked for {dev}")
        collect = collect_structural_mode_data if structural else _collect_mode_data
        mode_data_all, slab_meta = collect(plan, backend, rank)
    if spec is not None and spec.make_fit_data is not None:
        fit_data = spec.make_fit_data(tensor, weights, dev)
    else:
        fit_data = make_fit_data(tensor, dev)

    shapes = tuple(int(s) for s in tensor.shape)
    n_blocks, rem = divmod(n_iters, check_every)
    sweep_k = _build_sweep_block(backend, N, rank, shapes, slab_meta, solver,
                                 check_every, method) if n_blocks else None
    sweep_rem = _build_sweep_block(backend, N, rank, shapes, slab_meta, solver,
                                   rem, method) if rem else None

    fits_dev: list = []
    host_syncs = 0
    last_fit = -np.inf
    it = 0
    windows_run: list[int] = []
    tr = obs_trace.active()
    for b in range(n_blocks + (1 if rem else 0)):
        k = check_every if b < n_blocks else rem
        fn = sweep_k if b < n_blocks else sweep_rem
        start = state
        # A host span per window (queueing and its host read) when tracing.
        with (obs_trace.NULL if tr is None else
              tr.span("als.window", cat="als", backend=backend,
                      method=method, window=b, sweeps=k)):
            state, fits_blk, ok = fn(start, mode_data_all, fit_data)
            # The only in-window host sync: the last fit and the solve flag.
            if ok is None:
                f, healthy = float(fits_blk[-1]), True
            else:
                f, healthy = torch.stack(
                    [fits_blk[-1], ok.to(fits_blk.dtype)]).tolist()
            host_syncs += 1
            if not healthy:
                state, fits_blk, _ = fn(start, mode_data_all, fit_data,
                                        rescue=True)
                f = float(fits_blk[-1])
                host_syncs += 1
        fits_dev.append(fits_blk)
        windows_run.append(k)
        it += k
        if verbose:
            print(f"  ALS iter {it:3d}: fit={f:.6f} ({method}/fused)")
        if abs(f - last_fit) < tol:
            break
        last_fit = f

    host_syncs += 1                             # final materialization
    fits = torch.cat(fits_dev).tolist() if fits_dev else []

    mttkrp_seconds = 0.0
    if profile_mttkrp and windows_run and not structural:
        mttkrp_seconds = _profile_mttkrp_replay(
            backend, N, rank, shapes, slab_meta, state[0], mode_data_all,
            windows_run, dev)

    return CPDResult(
        factors=[F.cpu().numpy() for F in state[0]],
        weights=state[2].cpu().numpy().astype(np.float64),
        fits=fits,
        iters=it,
        mttkrp_seconds=mttkrp_seconds,
        total_seconds=obs_clock.now() - t_start,
        host_syncs=host_syncs,
        engine="fused",
        method=method,
    )


def _profile_mttkrp_replay(backend, nmodes, rank, shapes, slab_meta, factors,
                           mode_data_all, windows_run, device) -> float:
    """Wall time of the MTTKRP-only replay of the run's check windows, one
    ``_build_mttkrp_block`` per window length (a warm-up call of each
    first, outside the timing)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    total = 0.0
    for k in sorted(set(windows_run)):
        fn = _build_mttkrp_block(backend, nmodes, rank, shapes, slab_meta, k)
        fn(factors, mode_data_all)                  # warm-up
        sync()
        reps = windows_run.count(k)
        with obs_trace.span("mttkrp.replay", cat="als", backend=backend,
                            block=k, reps=reps):
            t0 = obs_clock.now()
            for _ in range(reps):
                fn(factors, mode_data_all)
            sync()
            total += obs_clock.now() - t0
    return total
