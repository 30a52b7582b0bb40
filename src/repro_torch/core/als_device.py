"""Device-resident CPD-ALS (port of ``repro.core.als_device``).

The whole N-mode sweep -- MTTKRP (slab / segment / coo backend), the
method's per-mode update (for CP: gram Hadamard, the ridge
normal-equations solve, column normalization) and the fit -- runs on the
device with the state carried there.  A ``check_every`` window of sweeps
is queued without any host read; the host reads once per window (the
last fit and a solve-health flag, in one transfer) and once at the end.
``CPDResult.host_syncs`` counts them.  One loop, ``_run_windows``, runs
the windows of this engine and of ``core.distributed``'s.

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

The fit.  ``<X, X_hat>`` is read off the last mode's MTTKRP, which
already sums every nonzero against the factors final for the sweep:
``sum_r w_r sum_i F_N[i, r] M_N[i, r]``, an (I_N, R) reduction with no
pass over the nonzeros (``_build_folded_fit``).  The masked method's
MTTKRP runs on residuals, not the tensor's values, so its weighted fit
keeps a pass of its own over the observed entries.

Distributed sweeps.  With ``axis`` (a ``launch.mesh.Mesh``) mode data and
fit data are one rank's shards (``core.distributed``) and the sweep sums
the partial MTTKRP outputs (and the masked fit's residual mass) over the
mesh -- the reference's ``lax.psum`` at the same points; the folded
fit's last-mode MTTKRP is already that sum.  On the slab backend that
is the kernel on this rank's packed shard, then ``mesh.psum``, then the
unrelabel (the reference's pallas branch with ``axis``); scheme-1 modes
of the segment backend may all-gather their owned rows instead
(``collectives``).  State stays replicated: every rank
computes the same update from the same summed MTTKRP.

Window functions are cached per (backend, nmodes, rank, shapes, slab
tiling, solver, block length, method), as the reference caches its
compiled sweep blocks; ``sweep_cache_stats()`` exposes the hits and
misses.  Each build registers in the build ledger (``obs.ledger.LEDGER``,
kind ``sweep_block``), and ``sweep_trace_stats()`` is the ledger's view
of the sweep blocks: the port's counterpart of the reference's trace
counts, where a build takes the place of an XLA trace.

Issuing a sweep.  The same sweep steps (``build_sweep_steps``) run in one
of two ways.  Eagerly: ``build_lane_sweep`` dispatches each operation,
about a hundred a sweep.  Or, where ``uses_graphs`` holds (a card, a
plan the caller holds, a method whose sweep reads nothing on the host),
as replays of CUDA graphs captured once per plan (``SweepGraphs``): one
graph per span below, 2N + 1 replays a sweep.  Both open their spans
through ``issue_sweep``, a window through ``_EagerWindows`` or
``_ReplayWindows``.  The arithmetic, the kernels, their launch shapes
and the host read a window are the same either way;
``CPDResult.graph_sweeps`` counts the sweeps replayed.

Spans (``obs.trace``, in a Tracer and a recording ``torch.profiler``):
``cpd.prepare`` (the uploads, mode data, fit data and block lookups, with
``h2d_bytes``), ``als.window`` per window (``graph``: replayed or not),
inside it per sweep ``als.mttkrp`` and ``als.update`` per mode and one
``als.fit`` (its ``source``: "mttkrp" for the folded fit, "nonzeros" for
the weighted one), then ``cpd.finish`` (the fits read, the download, the
result).
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
from ..kernels import mttkrp_slab as slab_kernels
from ..kernels.mttkrp_slab import (mttkrp_slab, mttkrp_slab_batched,
                                   mttkrp_slab_valued, scatter_slab_values)
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
                      slab_meta: tuple | None, axis=None,
                      collectives: tuple[str, ...] | None = None):
    """``one_mttkrp(d, mode_data, factors) -> (I_d, R)`` in original row
    order, with values baked into the mode data:

      slab:    (idx_packed, vals_packed, lrows_packed, rb_of, chunks, row_perm)
      segment: (idx, rows, vals, row_perm)
      coo:     (indices, values)

    With ``axis`` (a mesh) the mode data is this rank's shard (for slab,
    the shard packed by ``kernels.ops.pack_slabs``) and the partial
    outputs are summed over the mesh before the unrelabel.
    ``collectives[d] == "gather"`` (segment, scheme 1 only): each rank
    all-gathers just its owned relabeled rows and their original-row
    destinations and scatters them into a buffer whose dummy row I_d
    absorbs the padding slots; mode data widens to ``(idx, rows, vals,
    row_perm, own_rows, gather_dst)`` (``core.plan.DeviceShards``).
    """
    in_modes = [tuple(w for w in range(nmodes) if w != d)
                for d in range(nmodes)]

    def one_mttkrp(d, mode_data, factors):
        in_f = [factors[w] for w in in_modes[d]]
        if backend == "slab":
            if axis is None:
                return slab_backend(mode_data, in_f, shapes[d], slab_meta[d])
            idxp, valsp, lrowsp, rb_of, chunks, row_perm = mode_data
            nrb, br, tile, rblk = slab_meta[d]
            out = mttkrp_slab(idxp, valsp, lrowsp, rb_of, in_f, chunks=chunks,
                              num_row_blocks=nrb, block_rows=br, tile=tile,
                              rank_block=rblk)[:shapes[d]]
            return unrelabel_rows(axis.psum(out), row_perm)
        if backend == "segment":
            if collectives is not None and collectives[d] == "gather":
                idx, rows, vals, row_perm, own_rows, gather_dst = mode_data
                out = kref.mttkrp_sorted_segments(idx, rows, vals, in_f,
                                                  shapes[d])
                R = out.shape[-1]
                g_vals = axis.all_gather(out.index_select(0, own_rows))
                g_dst = axis.all_gather(gather_dst)
                full = torch.zeros((shapes[d] + 1, R), dtype=out.dtype,
                                   device=out.device)
                full.index_copy_(0, g_dst.reshape(-1).long(),
                                 g_vals.reshape(-1, R))
                return full[:shapes[d]]
            idx, rows, vals, row_perm = mode_data
            out = kref.mttkrp_sorted_segments(idx, rows, vals, in_f, shapes[d])
            if axis is not None:
                out = axis.psum(out)
            return unrelabel_rows(out, row_perm)
        if backend == "coo":
            indices, values = mode_data
            out = kref.mttkrp_coo(indices, values, list(factors), d, shapes[d])
            return out if axis is None else axis.psum(out)
        raise ValueError(f"unknown backend {backend!r}")

    return one_mttkrp


def _build_valued_mttkrp(backend: str, nmodes: int, shapes: tuple[int, ...],
                         slab_meta: tuple | None, axis=None):
    """``mttkrp_valued(d, mode_data, factors, vals) -> (I_d, R)``: the
    valued entry.  Mode data carries only the structural layout arrays; a
    fresh canonical-order value vector (the masked method's per-sweep
    residual) runs through the same kernels:

      slab:    (idx_packed, lrows_packed, rb_of, chunks, row_perm, perm,
                val_scatter)            vals[perm] scattered into the slabs
      segment: (idx, rows, row_perm, perm)     vals_layout = vals[perm]
      coo:     (indices,)                      canonical order already

    With ``axis`` (the distributed engine, segment backend only) the mode
    data is this rank's valued shard ``(idx, rows, row_perm, idx_full,
    vals, ew)``, ``vals`` arrives in the shard's own order (the residual
    at the shard's coordinates, ``MethodSpec.shard_values``) and the
    partial outputs are summed over the mesh.
    """
    in_modes = [tuple(w for w in range(nmodes) if w != d)
                for d in range(nmodes)]

    if axis is not None:
        if backend != "segment":
            raise NotImplementedError(
                "the distributed valued MTTKRP runs on the segment backend, "
                f"got {backend!r}")

        def mttkrp_valued_dist(d, mode_data, factors, vals):
            idx, rows, row_perm = mode_data[:3]
            out = kref.mttkrp_sorted_segments(
                idx, rows, vals, [factors[w] for w in in_modes[d]], shapes[d])
            return unrelabel_rows(axis.psum(out), row_perm)

        return mttkrp_valued_dist

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
                       slab_meta: tuple | None, valued: bool, batched: bool,
                       axis=None, collectives: tuple[str, ...] | None = None):
    """``mttkrp_lanes(d, mode_data, factor_lanes, value_lanes) -> [M per
    lane]`` (``value_lanes`` is None unless ``valued``).

    One lane (``batched=False``): mode data as ``_collect_mode_data`` or
    ``collect_structural_mode_data`` give it.  A batch of lanes: on the
    slab backend, the bucket-mates' packings stacked along a leading lane
    dimension (``serve.batched_engine``) and ONE launch of the batched
    kernel; the other backends take a list of per-lane mode data and run
    each lane's MTTKRP in turn."""
    if valued:
        single = _build_valued_mttkrp(backend, nmodes, shapes, slab_meta, axis)
    else:
        single = _build_one_mttkrp(backend, nmodes, shapes, slab_meta, axis,
                                   collectives)
    if batched and axis is not None:
        raise ValueError("a distributed sweep runs one lane per rank")
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


def _build_folded_fit(rank: int):
    """The sparse fit folded into the last mode's MTTKRP ``M`` (I_N, R):
    ``<X, X_hat> = sum_r w_r sum_i F_N[i, r] M[i, r]`` plus the
    gram-product model norm; no pass over the nonzeros, no dense
    reconstruction, no host read.  ``M`` must come from the factors that
    are final for the sweep (the last mode's MTTKRP does), whatever the
    update then made of ``F_N`` and ``w``.  Of the fit data it reads only
    ``norm_x_sq``, the last entry.  In a distributed sweep ``M`` is
    already summed over the mesh, so nothing is summed here."""

    def folded_fit(M, factors, grams, weights, fit_data):
        norm_x_sq = fit_data[-1]
        ip = ((M * factors[-1]).sum(0) * weights).sum()
        V = _hadamard_grams(grams, rank)
        model_sq = weights @ V @ weights
        resid_sq = torch.clamp(norm_x_sq - 2.0 * ip + model_sq, min=0.0)
        return 1.0 - torch.sqrt(resid_sq) / torch.clamp(
            torch.sqrt(norm_x_sq), min=1e-12)

    return folded_fit


def _build_weighted_fit(nmodes: int, rank: int, axis=None):
    """Observed-only weighted fit of the masked method:
    ``1 - sqrt(sum_e w_e (x_e - model_e)^2) / sqrt(sum_e w_e x_e^2)``.
    ``fit_data = (indices, values, entry_weights, weighted_norm_sq)``;
    weight-0 entries (nnz padding, or entries the caller masked out) add
    exactly +0.0.  ``grams`` is unused.  With ``axis`` the residual mass
    of this rank's shard is summed over the mesh."""

    def weighted_fit(factors, grams, weights, fit_data):
        indices, values, ew, norm_x_sq = fit_data
        resid = values - kref.cp_model_at_coords(indices, factors, weights)
        resid_sq = torch.sum(ew * resid * resid)
        if axis is not None:
            resid_sq = axis.psum(resid_sq)
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
    folded_fit: Callable      # (M_N, factors, grams, weights, fit_data)
    weighted_fit: Callable    # (factors, grams, weights, fit_data) -> fit
    hadamard: Callable        # (grams, exclude=None) -> (R, R)


def make_sweep_context(backend: str, nmodes: int, rank: int,
                       shapes: tuple[int, ...], slab_meta: tuple | None,
                       solver: str, valued: bool = False,
                       batched: bool = False, axis=None,
                       collectives: tuple[str, ...] | None = None
                       ) -> SweepContext:
    """The context a sweep hands its method: the lane MTTKRP of the
    value-baked (``valued=False``) or valued entry, for one lane or a
    batch, and the shared solve, normalization, Hadamard and fits
    (summed over the mesh ``axis`` when one is given)."""
    lane_mttkrp = _build_lane_mttkrp(backend, nmodes, shapes, slab_meta,
                                     valued, batched, axis, collectives)
    return SweepContext(
        nmodes=nmodes, rank=rank, shapes=shapes,
        one_mttkrp=None if valued else lane_mttkrp,
        mttkrp_valued=lane_mttkrp if valued else None,
        solve=_solve_with_rescue(_build_solver(rank, solver)),
        normalize=normalize_columns,
        folded_fit=_build_folded_fit(rank),
        weighted_fit=_build_weighted_fit(nmodes, rank, axis),
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


@dataclasses.dataclass(frozen=True)
class SweepSteps:
    """The arithmetic of one sweep over lanes, in the pieces its spans
    hold; ``factors``, ``grams``, ``weights`` and ``oks`` are per-lane
    lists that ``update`` advances in place (a lane's factor and gram
    lists are rebound to new tensors, never written into).

      values(d, mode_data_all, factors, weights, fit_data) -> value lanes
          (None unless the method's MTTKRP runs on fresh values)
      mttkrp(d, mode_data, factors, values) -> [M per lane]   (als.mttkrp)
      update(d, Ms, factors, grams, weights, oks, rescue)     (als.update)
      fit(Ms, factors, grams, weights, fit_data) -> [fit]     (als.fit)

    ``build_lane_sweep`` issues them eagerly; ``SweepGraphs`` captures
    one lane's ``mttkrp``, ``update`` and ``fit`` as CUDA graphs."""

    values: Callable
    mttkrp: Callable
    update: Callable
    fit: Callable
    weighted: bool


def build_sweep_steps(backend: str, nmodes: int, rank: int,
                      shapes: tuple[int, ...], slab_meta: tuple | None,
                      solver: str, method: str = "cp", batched: bool = False,
                      axis=None, collectives: tuple[str, ...] | None = None
                      ) -> SweepSteps:
    """The steps of ``build_lane_sweep``'s sweep (see ``SweepSteps``)."""
    spec = _method_spec(method)
    valued = spec is not None and spec.valued_mode_data
    ctx = make_sweep_context(backend, nmodes, rank, shapes, slab_meta, solver,
                             valued, batched, axis, collectives)
    method_update = spec.update if spec is not None and spec.update else cp_update
    values_for = spec.mttkrp_values if valued else None
    if valued and axis is not None:
        if spec.shard_values is None:
            raise NotImplementedError(
                f"method {method!r} has no values at a rank's shard")
        shard_values = spec.shard_values
    weighted = spec is not None and spec.weighted_fit

    def values(d, mode_data_all, factors, weights, fit_data):
        if valued and axis is not None:
            return [shard_values(ctx, factors[0], weights[0], mode_data_all[d])]
        if valued:
            return [values_for(ctx, F, w, fd)
                    for F, w, fd in zip(factors, weights, fit_data)]
        return None

    def update(d, Ms, factors, grams, weights, oks, rescue):
        for b, M in enumerate(Ms):
            Yd, lam, ok = method_update(ctx, d, M, factors[b], grams[b],
                                        weights[b], rescue)
            factors[b][d] = Yd
            grams[b][d] = Yd.T @ Yd
            weights[b] = lam
            if ok is not None:
                oks[b].append(ok)

    def fit(Ms, factors, grams, weights, fit_data):
        # Ms is the last mode's MTTKRP, one (I_N, R) output per lane.
        if weighted:
            return [ctx.weighted_fit(F, G, w, fd) for F, G, w, fd
                    in zip(factors, grams, weights, fit_data)]
        return [ctx.folded_fit(M, F, G, w, fd) for M, F, G, w, fd
                in zip(Ms, factors, grams, weights, fit_data)]

    return SweepSteps(values=values,
                      mttkrp=ctx.mttkrp_valued if valued else ctx.one_mttkrp,
                      update=update, fit=fit, weighted=weighted)


def issue_sweep(tr, nmodes: int, lanes: int, weighted: bool, mttkrp,
                update, fit, values=None):
    """One sweep's spans around its steps, for both ways of issuing it
    (``build_lane_sweep``'s eager steps, ``SweepGraphs``' replays): per
    mode ``values(d)`` outside the spans, ``mttkrp(d)`` in ``als.mttkrp``
    and ``update(d)`` in ``als.update``, then ``fit()`` in ``als.fit``,
    whose value it returns.  ``tr`` is ``obs_trace.sink()``."""
    for d in range(nmodes):
        if values is not None:
            values(d)
        with (obs_trace.NULL if tr is None else
              tr.span("als.mttkrp", cat="als", mode=d, lanes=lanes)):
            mttkrp(d)
        with (obs_trace.NULL if tr is None else
              tr.span("als.update", cat="als", mode=d)):
            update(d)
    with (obs_trace.NULL if tr is None else
          tr.span("als.fit", cat="als",
                  source="nonzeros" if weighted else "mttkrp")):
        return fit()


def build_lane_sweep(backend: str, nmodes: int, rank: int,
                     shapes: tuple[int, ...], slab_meta: tuple | None,
                     solver: str, method: str = "cp", batched: bool = False,
                     axis=None, collectives: tuple[str, ...] | None = None):
    """One full sweep over lanes: ``sweep(states, mode_data_all, fit_data,
    rescue=False) -> (states, fits, oks)``, one entry per lane in each
    list.  ``mode_data_all`` is one lane's (``batched=False``) or the
    batch's (see ``_build_lane_mttkrp``); ``fit_data`` has one entry per
    lane.  ``oks[b]`` is lane b's on-device solve flag (None for a method
    without a solve).  No state is updated in place, so a caller may keep
    the previous one.  With ``axis`` the one lane is this rank's shard
    (see ``build_sweep_fn``)."""
    steps = build_sweep_steps(backend, nmodes, rank, shapes, slab_meta,
                              solver, method, batched, axis, collectives)

    def sweep(states, mode_data_all, fit_data, rescue=False):
        factors = [list(st[0]) for st in states]
        grams = [list(st[1]) for st in states]
        weights = [st[2] for st in states]
        oks = [[] for _ in states]
        vals = Ms = None

        def values(d):
            nonlocal vals
            vals = steps.values(d, mode_data_all, factors, weights, fit_data)

        def mttkrp(d):
            nonlocal Ms
            Ms = steps.mttkrp(d, mode_data_all[d], factors, vals)

        fits = issue_sweep(
            obs_trace.sink(), nmodes, len(states), steps.weighted, mttkrp,
            lambda d: steps.update(d, Ms, factors, grams, weights, oks, rescue),
            lambda: steps.fit(Ms, factors, grams, weights, fit_data), values)
        states = [(tuple(F), tuple(G), w)
                  for F, G, w in zip(factors, grams, weights)]
        return states, fits, [torch.stack(o).all() if o else None for o in oks]

    return sweep


def build_sweep_fn(backend: str, nmodes: int, rank: int,
                   shapes: tuple[int, ...], slab_meta: tuple | None,
                   solver: str, method: str = "cp", axis=None,
                   collectives: tuple[str, ...] | None = None):
    """One full sweep of one tensor: ``sweep(state, mode_data_all,
    fit_data, rescue=False) -> (state, fit, ok)``, the one-lane case of
    ``build_lane_sweep``.  ``rescue=True`` replaces a failed solve by
    ``M @ pinv(Vr)``.

    ``axis``: a mesh (``launch.mesh.Mesh``); mode and fit data are then
    this rank's shards and the partial MTTKRPs (and the masked fit's
    residual mass) are summed over it (the distributed path).
    ``collectives``: per-mode "psum" or "gather" for the distributed
    segment path (see ``_build_one_mttkrp``)."""
    if collectives is not None:
        if axis is None or backend != "segment":
            raise ValueError(
                "per-mode collectives apply to the distributed segment "
                "path only (axis set, backend='segment')")
        if len(collectives) != nmodes or any(
                c not in ("psum", "gather") for c in collectives):
            raise ValueError(f"bad collectives {collectives!r}")
    lanes = build_lane_sweep(backend, nmodes, rank, shapes, slab_meta,
                             solver, method, axis=axis,
                             collectives=collectives)

    def sweep(state, mode_data_all, fit_data, rescue=False):
        states, fits, oks = lanes([state], mode_data_all, [fit_data], rescue)
        return states[0], fits[0], oks[0]

    return sweep


@functools.lru_cache(maxsize=None)
def _build_sweep_block(backend: str, nmodes: int, rank: int,
                       shapes: tuple[int, ...], slab_meta: tuple | None,
                       solver: str, block: int, method: str = "cp",
                       axis=None, collectives: tuple[str, ...] | None = None):
    """``run_block(state, mode_data_all, fit_data, rescue=False) ->
    (state, fits (block,), ok)``: ``block`` sweeps queued back to back with
    no host read (a gloo mesh's staged collectives aside).  ``ok`` is None
    for a method without a solve.  With ``axis`` the build registers as
    kind ``dist_block``."""
    sweep = build_sweep_fn(backend, nmodes, rank, shapes, slab_meta, solver,
                           method, axis=axis, collectives=collectives)

    def run_block(state, mode_data_all, fit_data, rescue=False):
        fits, ok = [], None
        for _ in range(block):
            state, fit, ok_s = sweep(state, mode_data_all, fit_data, rescue)
            fits.append(fit)
            if ok_s is not None:
                ok = ok_s if ok is None else ok & ok_s
        return state, torch.stack(fits), ok

    if axis is not None:
        return LEDGER.register(
            "dist_block",
            (backend, nmodes, rank, shapes, slab_meta, solver, "kappa",
             axis.size, "block", block, "method", method, "collectives",
             collectives),
            run_block)
    return LEDGER.register(
        "sweep_block",
        (backend, nmodes, rank, shapes, slab_meta, solver, "block", block,
         "method", method),
        run_block)


def uses_graphs(device, caller_plan: bool, method: str) -> bool:
    """Whether a fused call issues its sweeps as replays of captured CUDA
    graphs (``SweepGraphs``) rather than eagerly: on a CUDA device, with
    a plan the caller holds (the capture, made once per plan, pays off
    over the plan's later calls), and for a method whose sweep reads
    nothing on the host (the folded fit: not the masked method's weighted
    fit and valued MTTKRP).  Mesh calls never reach ``cpd_als_fused``
    (``core.distributed`` runs eager ``dist_block`` windows), so they
    stay eager."""
    if torch.device(device).type != "cuda" or not caller_plan:
        return False
    spec = _method_spec(method)
    return spec is None or not (spec.weighted_fit or spec.valued_mode_data)


class _Graph:
    """A CUDA graph in memory pool ``pool``.  A kernel wrapper called
    under ``capture`` counts in ``mttkrp_slab.CAPTURES``; each ``replay``
    adds those calls to ``mttkrp_slab.LAUNCHES``, since it launches the
    kernels without the wrapper."""

    def __init__(self, pool):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool
        self.counts = []

    def capture(self, fn, *args):
        """Capture ``fn(*args)``; what it returns are the buffers each
        replay writes."""
        before = dict(slab_kernels.CAPTURES)
        with torch.cuda.graph(self.graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            out = fn(*args)
        self.counts = [(k, n - before[k])
                       for k, n in slab_kernels.CAPTURES.items()
                       if n != before[k]]
        return out

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.counts:
            slab_kernels.LAUNCHES[k] += n


def graph_pool_bytes(pool, device) -> int:
    """Bytes of the allocator's segments that belong to a graph memory
    pool on ``device``: reserved while its graphs live, written by their
    replays, and not seen by ``torch.cuda.memory_allocated`` once the
    capture's temporaries are freed into the pool."""
    pool, index = tuple(pool), torch.device(device).index or 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg.get("device") == index
               and tuple(seg.get("segment_pool_id", ())) == pool)


class SweepGraphs:
    """One lane's sweep as CUDA graphs, one per span the sweep has:
    ``als.mttkrp`` and ``als.update`` per mode and ``als.fit``, 2N + 1
    graphs in one memory pool, captured from ``build_sweep_steps``'s
    steps.  The graphs read and advance a state held in static buffers
    (``load`` fills them), so a window of k sweeps is k replays of the
    chain, each inside its span (``issue_sweep``).  ``fits`` holds the
    last fits, the newest last: a ring as long as the longest window yet,
    whose graph is captured again when a longer window comes.  ``ok`` is
    the solves' flag since the last ``load``.

    Capture happens once, after a call has run the sweep eagerly on the
    same plan (the slab launcher's build and shared-memory attributes,
    the BLAS and solver handles are then in place).  cuBLAS keeps one
    workspace per stream, and a capture runs on a side stream, whose
    workspace comes from the graphs' pool.  The workspaces are dropped
    after the capture: the side stream's stays reserved in the pool for
    the replays, and the eager stream's is made again only by a later
    eager BLAS call.  ``pool_bytes`` counts the pool (the static buffers
    are ordinary allocations).  The buffers are the plan's: its graphs
    serve one call at a time."""

    def __init__(self, steps: SweepSteps, mode_data_all, state, norm_x_sq,
                 ring: int):
        self.device = state[2].device
        self.nmodes = len(state[0])
        self._steps = steps
        self._leaves = [torch.empty_like(t) for t in (*state[0], *state[1],
                                                      state[2])]
        self._start = None
        self.norm_x_sq = torch.empty((), dtype=torch.float32,
                                     device=self.device)
        self.ok = torch.ones((), dtype=torch.bool, device=self.device)
        self.solves = False
        self.load(state)
        self.norm_x_sq.copy_(norm_x_sq)
        F, G, w = self.state()

        def advance(d, M):
            factors, grams, weights, oks = [list(F)], [list(G)], [w], [[]]
            steps.update(d, [M], factors, grams, weights, oks, False)
            F[d].copy_(factors[0][d])
            G[d].copy_(grams[0][d])
            w.copy_(weights[0])
            for ok in oks[0]:
                self.ok.logical_and_(ok)
                self.solves = True

        self._pool = torch.cuda.graph_pool_handle()
        self._mttkrp, self._update = [], []
        for d in range(self.nmodes):
            self._mttkrp.append(_Graph(self._pool))
            self._update.append(_Graph(self._pool))
            M = self._mttkrp[d].capture(steps.mttkrp, d, mode_data_all[d],
                                        [list(F)], None)[0]
            self._update[d].capture(advance, d, M)
        # The last mode's output stays for the fit; the others' blocks
        # went back to the pool once their update was captured.
        self._m_last = M
        self._capture_fit(ring)
        # One replay uploads each graph before a measured one; its kernel
        # launches count as any replay's.
        self.sweep(None)

    def _capture_fit(self, ring: int) -> None:
        F, G, w = self.state()
        self.fits = torch.zeros((ring,), dtype=torch.float32,
                                device=self.device)

        def fit(M):
            f = self._steps.fit([M], [F], [G], [w], [(self.norm_x_sq,)])[0]
            self.fits.copy_(torch.cat([self.fits[1:], f.reshape(1)]))

        self._fit = _Graph(self._pool)
        self._fit.capture(fit, self._m_last)
        torch._C._cuda_clearCublasWorkspaces()
        self.pool_bytes = graph_pool_bytes(self._pool, self.device)

    def _as_state(self, leaves):
        N = self.nmodes
        return tuple(leaves[:N]), tuple(leaves[N:2 * N]), leaves[2 * N]

    def state(self):
        """The static state the graphs advance (not a copy)."""
        return self._as_state(self._leaves)

    def load(self, state) -> None:
        """Copy ``state`` into the static buffers, clear ``ok`` and drop
        the last call's window start."""
        factors, grams, weights = state
        torch._foreach_copy_(self._leaves, [*factors, *grams, weights])
        self.ok.fill_(True)
        self._start = None

    def window_start(self):
        """A copy of the static state, for the eager rescue of a window
        whose solves failed.  Its buffers are made at a call's first
        window, after the fit data's upload, and live until the next
        ``load``."""
        if self._start is None:
            self._start = [torch.empty_like(t) for t in self._leaves]
        torch._foreach_copy_(self._start, self._leaves)
        return self._as_state(self._start)

    def sweep(self, tr) -> None:
        """Replay one sweep, each graph inside its span of ``tr``."""
        issue_sweep(tr, self.nmodes, 1, False,
                    lambda d: self._mttkrp[d].replay(),
                    lambda d: self._update[d].replay(), self._fit.replay)

    def run_window(self, k: int, tr):
        """``k`` sweeps from the static state: ``(fits (k,), ok)``, the
        fits a copy, ``ok`` the static flag (None without a solve)."""
        if k > self.fits.numel():
            self._capture_fit(k)
        for _ in range(k):
            self.sweep(tr)
        return self.fits[-k:].clone(), self.ok if self.solves else None


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


def _collect_mode_data(plan: MTTKRPPlan, backend: str, rank: int,
                       structural: bool = False):
    """Per-mode device arrays (cached on the plan), value-baked or
    ``structural`` (``collect_structural_mode_data``), and the slab
    tiling (None off the slab backend)."""
    N = plan.tensor.nmodes
    if backend == "coo":
        coo = plan.device_coo()
        return tuple(coo[:1] if structural else coo for _ in range(N)), None
    if backend not in ("slab", "segment"):
        raise ValueError(f"unknown backend {backend!r}")
    if structural:
        datas = tuple(plan.device_structural(d, backend) for d in range(N))
    elif backend == "slab":
        datas = tuple(plan.device_packed(d) for d in range(N))
    else:
        datas = tuple(plan.device_arrays(d) for d in range(N))
    metas = (tuple(plan.slab_meta(d, rank) for d in range(N))
             if backend == "slab" else None)
    return datas, metas


def collect_structural_mode_data(plan: MTTKRPPlan, backend: str, rank: int):
    """Mode data for the valued MTTKRP (see ``_build_valued_mttkrp``):
    structural layout arrays plus the canonical->layout permutation (and
    the layout->slab scatter for slab), no baked values.  The masked
    method collects through here."""
    return _collect_mode_data(plan, backend, rank, structural=True)


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


def _initial_host_state(spec, tensor_shape, rank: int, seed: int,
                        init_state=None):
    """A call's host start: the caller's ``init_state``, else the method's
    seeded init, else ``init_state_host``'s."""
    if init_state is not None:
        return init_state
    if spec is not None and spec.init_state_host is not None:
        return spec.init_state_host(tensor_shape, rank, seed)
    return init_state_host(tensor_shape, rank, seed)


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


def make_fit_data(tensor: SparseTensor, device, staged=None) -> tuple:
    """``(index columns, values, norm_x_sq)`` of the sparse fit on
    ``device``; the folded fit reads only ``norm_x_sq``.  ``staged`` --
    ``MTTKRPPlan.staged_fit_data()``: the host side made once, uploaded
    from page-locked memory (default: made from ``tensor`` now)."""
    if staged is None:
        staged = (torch.from_numpy(tensor.indices),
                  torch.from_numpy(tensor.values.astype(np.float32)),
                  tensor.norm() ** 2)
    host_idx, host_vals, norm_sq = staged
    idx = host_idx.to(device, non_blocking=True)
    return (
        tuple(idx[:, d].contiguous() for d in range(tensor.nmodes)),
        host_vals.to(device, non_blocking=True),
        torch.tensor(norm_sq, dtype=torch.float32, device=device),
    )


def _nbytes(arrays) -> int:
    """Summed bytes of the tensors in a nest of tuples: what uploading
    them copied (a fit data's index columns are split on the device and
    add up to the one uploaded index array)."""
    if isinstance(arrays, torch.Tensor):
        return arrays.nbytes
    return sum(_nbytes(a) for a in arrays)


# ---------------------------------------------------------------------------
# Window loop
# ---------------------------------------------------------------------------


def _run_windows(runner, tol: float, read, span, label):
    """The windows of a call, window ``b`` of ``k`` sweeps
    (``runner.lengths``) in ``span(b, k)``: ``runner.window(k) -> (fits,
    ok)``, one host sync ``read(last fit, ok) -> (fit, healthy)``, and if
    not healthy ``runner.rescue(k) -> fits`` and a second read.  Returns
    ``(fits per window on the device, sweeps run, host syncs)``."""
    fits, it, host_syncs, last_fit = [], 0, 0, -np.inf
    for b, k in enumerate(runner.lengths):
        with span(b, k):
            fits_blk, ok = runner.window(k)
            f, healthy = read(fits_blk[-1], ok)
            host_syncs += 1
            if not healthy:
                fits_blk = runner.rescue(k)
                f, _ = read(fits_blk[-1], None)
                host_syncs += 1
        fits.append(fits_blk)
        it += k
        if label is not None:
            print(f"  ALS iter {it:3d}: fit={f:.6f} ({label})")
        if abs(f - last_fit) < tol:
            break
        last_fit = f
    return fits, it, host_syncs


class _EagerWindows:
    """Windows of ``check_every`` sweeps, then the rest, run eagerly by
    ``block(k)``, the window function of each length, built up front;
    ``rescue`` reruns the last from ``start``."""

    graph_sweeps = 0

    def __init__(self, block, n_iters, check_every, state, mode_data_all,
                 fit_data):
        full, rem = divmod(n_iters, check_every)
        self.lengths = [check_every] * full + ([rem] if rem else [])
        self._blocks = {k: block(k) for k in dict.fromkeys(self.lengths)}
        self._data = (mode_data_all, fit_data)
        self.state = state

    def window(self, k: int):
        self.start = self.state
        self.state, fits, ok = self._blocks[k](self.start, *self._data)
        return fits, ok

    def rescue(self, k: int):
        self.state, fits, _ = self._blocks[k](self.start, *self._data,
                                              rescue=True)
        return fits


class _ReplayWindows:
    """Windows replayed from a plan's ``SweepGraphs`` in the spans of
    ``tr``; ``eager`` reruns a failed one from a copy of its start, and
    its sweeps do not count as replayed."""

    def __init__(self, graphs: SweepGraphs, eager: _EagerWindows,
                 norm_x_sq, tr):
        graphs.norm_x_sq.copy_(norm_x_sq)
        self._graphs, self._eager, self._tr = graphs, eager, tr
        self.lengths, self.graph_sweeps = eager.lengths, 0

    @property
    def state(self):
        return self._graphs.state()

    def window(self, k: int):
        self._eager.start = self._graphs.window_start()
        self.graph_sweeps += k
        return self._graphs.run_window(k, self._tr)

    def rescue(self, k: int):
        fits = self._eager.rescue(k)
        self._graphs.load(self._eager.state)
        self.graph_sweeps -= k
        return fits


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
    instead of the method's seeded init.

    ``CPDResult.h2d_bytes`` counts the call's own uploads: the initial
    state, the fit data (from the plan's page-locked copy where the plan
    is of this tensor and on a card) and, on the coo backend without a
    plan, the COO arrays.  A plan's device arrays are uploaded once per
    plan (cached on it) and not counted, also where this call built the
    plan.

    Where ``uses_graphs`` holds (a card, the caller's ``plan``, cp or
    nncp), the plan's first such call runs eagerly and then captures the
    sweep as CUDA graphs, cached on the plan (``SweepGraphs``); every
    later call replays them, window by window, with the same host read a
    window.  A window whose solves failed reruns eagerly from its start
    with the rescue.  ``CPDResult.graph_sweeps`` counts the sweeps
    replayed."""
    t_start = obs_clock.now()
    dev = resolve_device(device)
    N = tensor.nmodes
    check_every = max(1, int(check_every))
    graphed = uses_graphs(dev, plan is not None, method)
    tr = obs_trace.sink()
    with (obs_trace.NULL if tr is None else
          tr.span("cpd.prepare", cat="cpd")) as prep:
        spec = _method_spec(method)
        if weights is not None:
            if spec is None or not spec.weighted_fit:
                raise ValueError(
                    f"per-entry weights require a weighted-fit method "
                    f"(e.g. 'masked'), got method={method!r}")
            weights = normalize_entry_weights(
                validate_entry_weights(tensor.nnz, weights))
        state = state_from_reference(
            *_initial_host_state(spec, tensor.shape, rank, seed, init_state),
            device=dev)
        h2d_bytes = _nbytes(state)
        solver = resolve_solver(solver, dev)

        structural = spec is not None and spec.valued_mode_data
        if plan is None and backend == "coo":
            # The coo backend needs no mode-specific layouts.
            idx = torch.as_tensor(tensor.indices, device=dev)
            coo = ((idx,) if structural else
                   (idx, torch.as_tensor(tensor.values.astype(np.float32),
                                         device=dev)))
            h2d_bytes += _nbytes(coo)
            mode_data_all, slab_meta = tuple(coo for _ in range(N)), None
        else:
            if plan is None:
                plan = make_plan(tensor, kappa, device=dev)
            elif plan.device != dev:
                raise ValueError(
                    f"plan lives on {plan.device}, run asked for {dev}")
            mode_data_all, slab_meta = _collect_mode_data(plan, backend, rank,
                                                          structural)
        # The sweep's key: its window functions' arguments but the window
        # length, and the key of the plan's captured graphs.
        key = (backend, N, rank, tuple(int(s) for s in tensor.shape),
               slab_meta, solver, method)
        graphs = plan._graphs.get(key) if graphed else None
        replay = graphs is not None
        if replay:
            # The state moves into the graphs' buffers before the fit
            # data's upload, so the call holds one copy of it there.
            graphs.load(state)
            state = None
        if spec is not None and spec.make_fit_data is not None:
            fit_data = spec.make_fit_data(tensor, weights, dev)
        else:
            fit_data = make_fit_data(
                tensor, dev, None if plan is None or plan.tensor is not tensor
                else plan.staged_fit_data())
        h2d_bytes += _nbytes(fit_data)
        runner = _EagerWindows(
            lambda k: _build_sweep_block(*key[:-1], k, method), n_iters,
            check_every, state, mode_data_all, fit_data)
        if replay:
            runner = _ReplayWindows(graphs, runner, fit_data[-1], tr)
        prep.set(h2d_bytes=h2d_bytes)

    fits_dev, it, host_syncs = _run_windows(
        runner, tol,
        # A window's one host read, one transfer: the last fit and, where
        # the method solves, the solve flag.
        lambda fit, ok: ((float(fit), True) if ok is None else
                         torch.stack([fit, ok.to(fit.dtype)]).tolist()),
        # A host span per window (queueing and its host read) when tracing.
        lambda b, k: (obs_trace.NULL if tr is None else
                      tr.span("als.window", cat="als", backend=backend,
                              method=method, window=b, sweeps=k,
                              graph=replay)),
        f"{method}/fused" if verbose else None)

    with obs_trace.NULL if tr is None else tr.span("cpd.finish", cat="cpd"):
        host_syncs += 1                         # final materialization
        state = runner.state
        fits = torch.cat(fits_dev).tolist() if fits_dev else []
        result = CPDResult(
            factors=[F.cpu().numpy() for F in state[0]],
            weights=state[2].cpu().numpy().astype(np.float64),
            fits=fits,
            iters=it,
            mttkrp_seconds=0.0,
            total_seconds=obs_clock.now() - t_start,
            host_syncs=host_syncs,
            engine="fused",
            method=method,
            h2d_bytes=h2d_bytes,
            graph_sweeps=runner.graph_sweeps,
        )
    if graphed and not replay:
        # The capture, after the call's eager run and with its fit data
        # and fits released: the plan's first call of this rank and method.
        norm_x_sq = fit_data[-1]
        fit_data = fits_dev = runner = None
        plan._graphs[key] = SweepGraphs(build_sweep_steps(*key), mode_data_all,
                                        state, norm_x_sq, check_every)
    return result
