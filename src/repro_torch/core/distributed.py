"""Distributed spMTTKRP and CPD-ALS over a mesh of ranks (port of
``repro.core.distributed``).

The paper maps κ tensor partitions onto κ SMs; here κ is the number of
ranks of a 1-D mesh (``launch.mesh.Mesh``, axis "sm" as in the
reference).  Per-rank shards come from the planning layer
(``core.plan.build_device_shards``): each rank holds a rectangular,
zero-padded slice of every mode layout with GLOBAL relabeled rows,
computes a partial (I_d, R) MTTKRP, and a sum over the mesh combines the
partials:

  Scheme 1 (I_d >= κ): the partials have disjoint row support; the psum
    still moves the whole (I_d, R) array per rank, and
    ``collective="gather"`` moves only each rank's owned rows instead.
  Scheme 2 (I_d < κ): the partials overlap and the psum truly reduces.

The reference runs one controller that ``shard_map``s the sweep over its
devices.  PyTorch is multi-controller: every rank runs this module on the
same host tensor, builds the same plan, and uploads only its own slice
(``plan.modes[d].idx[rank]`` and the rest).  The sweep is the fused
engine's (``core.als_device.build_sweep_fn(axis=mesh)``) on the segment
backend, as in the reference; the slab kernel on a rank's packed shard
is the same sweep with ``backend="slab"`` on per-rank packings
(``kernels.ops.pack_slabs``).

Every rank takes every branch together.  A check window's single host
read is the summed fit and the solve flags of every rank, all-gathered
into one tensor and fetched once, so no rank leaves the loop (or reruns a
window under the pinv rescue) while another stays.  The state is
replicated: every rank computes the same update from the same summed
MTTKRP, and every rank returns the same ``CPDResult``.

``method=`` cp / nncp reuse the value-baked shards; masked gets shards
that also carry each entry's full coordinates, value and observation
weight (``weights=``), evaluates its residual at the shard's own
coordinates and sums the residual mass of the weighted fit.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..convert import state_from_reference
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels.mttkrp_slab import (max_rank_block, shared_memory_per_block,
                                   slab_chunks)
from ..launch.mesh import AXIS, Mesh, make_mesh
from ..obs import clock as obs_clock
from ..obs import trace as obs_trace
from . import plan as plan_mod
from .als_device import (_build_sweep_block, _method_spec,
                         normalize_entry_weights, resolve_solver,
                         validate_entry_weights)
from .als_device import init_state_host as _default_init_state_host
from .coo import SparseTensor
from .cpd import CPDResult
from .layout import build_mode_layout
from .load_balance import Scheme
from .mttkrp import unrelabel_rows


@dataclasses.dataclass
class DistributedPlan:
    """All-modes distributed plan over a 1-D mesh: one
    ``core.plan.DeviceShards`` per mode plus the sharded fit data (every
    rank's; a rank uploads its own).  ``method`` is part of the plan:
    masked shards carry other arrays than cp's."""

    tensor: SparseTensor
    mesh: Mesh
    modes: list[plan_mod.DeviceShards]
    fit_shards: tuple  # (idx (κ,per,N), vals (κ,per)[, ew], norm_sq (κ,))
    method: str = "cp"

    @property
    def kappa(self) -> int:
        return int(self.mesh.size)


def make_distributed_plan(
    tensor: SparseTensor,
    mesh: Mesh | None = None,
    *,
    scheme: Scheme | None = None,
    assignment: str = "greedy",
    method: str = "cp",
    weights: np.ndarray | None = None,
    device="cuda",
) -> DistributedPlan:
    """Per-rank shards for ``method``: the structural shards for
    value-baked methods, shards with full coordinates and observation
    weights (``weights=``, canonical COO order, default all ones; padding
    is weight 0) for valued ones.  ``scheme`` forces every mode's
    load-balancing scheme.  ``mesh`` defaults to every rank of the process
    group on ``device`` (one rank without a group)."""
    if mesh is None:
        mesh = _default_mesh(device)
    spec = _method_spec(method)
    structural = spec is not None and spec.valued_mode_data
    weighted = spec is not None and spec.weighted_fit
    if weights is not None:
        if not weighted:
            raise ValueError(
                f"per-entry weights require a weighted-fit method "
                f"(e.g. 'masked'), got method={method!r}")
        weights = normalize_entry_weights(
            validate_entry_weights(tensor.nnz, weights))
    ew_full = None
    if weighted:
        ew_full = (np.ones(tensor.nnz, np.float32) if weights is None
                   else weights)
    kappa = int(mesh.size)
    modes = []
    for d in range(tensor.nmodes):
        lay = build_mode_layout(tensor, d, kappa, scheme=scheme,
                                assignment=assignment)
        modes.append(plan_mod.build_device_shards(
            lay, weights=ew_full if structural else None,
            with_full_indices=structural))
    fit = plan_mod.shard_fit_data(tensor, kappa, weights=ew_full)
    return DistributedPlan(tensor=tensor, mesh=mesh, modes=modes,
                           fit_shards=fit, method=method)


def _default_mesh(device) -> Mesh:
    import torch.distributed as dist

    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return make_mesh((world,), (AXIS,), device=device)


# ---------------------------------------------------------------------------
# One-shot distributed MTTKRP
# ---------------------------------------------------------------------------


def mttkrp_distributed(plan: DistributedPlan, factors, mode: int) -> torch.Tensor:
    """Distributed MTTKRP along ``mode``: this rank's partial over its
    shard, summed over the mesh; (I_d, R) float32 in original row order on
    every rank.  ``factors`` are replicated (numpy or tensors)."""
    m = plan.modes[mode]
    r, dev = plan.mesh.rank, plan.mesh.device
    facs = [torch.as_tensor(np.asarray(factors[w], np.float32), device=dev)
            if not isinstance(factors[w], torch.Tensor) else factors[w]
            for w in m.input_modes]
    out = kref.mttkrp_sorted_segments(
        torch.as_tensor(m.idx[r], device=dev),
        torch.as_tensor(m.rows[r], device=dev),
        torch.as_tensor(m.vals[r], device=dev), facs, m.num_rows)
    row_perm = torch.as_tensor(m.row_perm[r].astype(np.int64), device=dev)
    return unrelabel_rows(plan.mesh.psum(out), row_perm)


# ---------------------------------------------------------------------------
# Collectives and this rank's data
# ---------------------------------------------------------------------------


def resolve_collectives(plan: DistributedPlan,
                        collective: str) -> tuple[str, ...] | None:
    """Per-mode collectives for ``collective`` ("psum" | "gather").
    "gather" applies where the shards support it (scheme 1, value-baked);
    scheme-2 modes keep the psum.  None for the pure psum."""
    if collective == "psum":
        return None
    if collective != "gather":
        raise ValueError(f"unknown collective {collective!r}")
    if plan.modes[0].idx_full is not None:
        raise ValueError(
            "collective='gather' supports value-baked methods only "
            "(cp, nncp); the valued/weighted contract psums residual "
            "MTTKRPs")
    return tuple("gather" if m.own_rows is not None else "psum"
                 for m in plan.modes)


def collective_payload_bytes(plan: DistributedPlan, rank: int,
                             collectives: tuple[str, ...] | None) -> int:
    """Bytes crossing the mesh per sweep to combine the N mode outputs:
    the psum moves every rank's (I_d, R) partial; the gather each rank's
    (rows_cap, R) owned slice plus its int32 destination map."""
    kappa = plan.kappa
    total = 0
    for d, m in enumerate(plan.modes):
        if collectives is not None and collectives[d] == "gather":
            total += kappa * m.rows_cap * (rank * 4 + 4)
        else:
            total += kappa * m.num_rows * rank * 4
    return int(total)


def _collect_dist_data(plan: DistributedPlan,
                       collectives: tuple[str, ...] | None = None):
    """This rank's mode data and fit data on its device, in the order the
    sweep expects: ``(idx, rows, vals, row_perm)`` per value-baked psum
    mode (``+ (own_rows, gather_map)`` for a gather mode), ``(idx, rows,
    row_perm, idx_full, vals, ew)`` per masked mode.  Only this rank's
    slice of each array is uploaded."""
    r, dev = plan.mesh.rank, plan.mesh.device

    def up(a, dtype=None):
        a = np.ascontiguousarray(a[r])
        return torch.as_tensor(a if dtype is None else a.astype(dtype),
                               device=dev)

    mode_data = []
    for d, m in enumerate(plan.modes):
        row_perm = up(m.row_perm, np.int64)
        if m.idx_full is not None:
            mode_data.append((up(m.idx), up(m.rows), row_perm, up(m.idx_full),
                              up(m.vals), up(m.ew)))
        elif collectives is not None and collectives[d] == "gather":
            mode_data.append((up(m.idx), up(m.rows), up(m.vals), row_perm,
                              up(m.own_rows, np.int64), up(m.gather_map)))
        else:
            mode_data.append((up(m.idx), up(m.rows), up(m.vals), row_perm))
    fit = plan.fit_shards
    if len(fit) == 4:      # weighted: (idx, vals, ew, norm_sq)
        fit_data = (up(fit[0]), up(fit[1]), up(fit[2]),
                    torch.tensor(float(fit[3][r]), dtype=torch.float32,
                                 device=dev))
    else:
        idx = up(fit[0])
        fit_data = (tuple(idx[:, d].contiguous() for d in range(idx.shape[1])),
                    up(fit[1]),
                    torch.tensor(float(fit[2][r]), dtype=torch.float32,
                                 device=dev))
    return tuple(mode_data), fit_data


def shard_slab_mode_data(plan: DistributedPlan, rank: int):
    """This rank's shard of every mode packed into slabs
    (``kernels.ops.pack_slabs``, default tiling) on its device, as ``(mode data, slab
    meta)`` for ``als_device.build_sweep_fn("slab", axis=mesh)``: the slab
    kernel on the rank's shard, then the sum over the mesh (the
    reference's pallas branch with ``axis``).  ``rank`` is the CP rank;
    the rank block fits the device's shared memory."""
    r, dev = plan.mesh.rank, plan.mesh.device
    smem = shared_memory_per_block(dev)
    datas, metas = [], []
    for d, m in enumerate(plan.modes):
        p = kops.pack_slabs(m.idx[r], m.rows[r], m.vals[r], m.num_rows,
                            mode=d, input_modes=m.input_modes)
        datas.append((torch.as_tensor(p.idx_packed, device=dev),
                      torch.as_tensor(p.vals_packed, device=dev),
                      torch.as_tensor(p.lrows_packed, device=dev),
                      torch.as_tensor(p.rb_of, device=dev),
                      slab_chunks(p.rb_of, p.num_row_blocks, dev),
                      torch.as_tensor(m.row_perm[r].astype(np.int64),
                                      device=dev)))
        metas.append((p.num_row_blocks, p.block_rows, p.tile,
                      max_rank_block(p.block_rows, smem, len(m.input_modes),
                                     widest=rank)))
    return tuple(datas), tuple(metas)


def window_read(mesh: Mesh, fit: torch.Tensor, ok) -> tuple[float, bool]:
    """The one host read of a check window, the same on every rank: the
    summed fit (rank 0's copy) and whether every rank's solves were
    healthy, all-gathered into one tensor and fetched once."""
    flag = (torch.ones((), dtype=fit.dtype, device=fit.device) if ok is None
            else ok.to(fit.dtype))
    g = mesh.all_gather(torch.stack([fit, flag]))
    f, healthy = torch.stack([g[0, 0], g[:, 1].min()]).tolist()
    return f, bool(healthy)


# ---------------------------------------------------------------------------
# Distributed CPD-ALS
# ---------------------------------------------------------------------------


def cpd_als_distributed(
    tensor: SparseTensor,
    rank: int,
    mesh: Mesh | None = None,
    *,
    plan: DistributedPlan | None = None,
    n_iters: int = 25,
    tol: float = 1e-5,
    seed: int = 0,
    check_every: int = 1,
    solver: str = "auto",
    method: str = "cp",
    weights: np.ndarray | None = None,
    init_state: tuple | None = None,
    collective: str = "psum",
    verbose: bool = False,
    device="cuda",
) -> CPDResult:
    """Distributed CPD-ALS, called on every rank of ``mesh`` with the same
    arguments: the fused engine's sweep on each rank's shards, partial
    MTTKRPs and fits summed over the mesh, one host read per
    ``check_every`` window plus one at the end.  Same init and update
    order as single-device ``cpd_als`` (same seed => the same factors to
    fp32 tolerance).

    ``method`` (cp, nncp, masked), ``weights`` (masked only) and
    ``init_state`` (a host state tuple) are the fused engine's contracts.
    ``collective``: "psum" (both schemes) or "gather" (scheme-1 modes
    all-gather their owned rows, about 1/κ of the psum's payload;
    scheme-2 modes keep the psum).  ``mesh`` defaults to every rank of the
    process group on ``device``."""
    t_start = obs_clock.now()
    spec = _method_spec(method)
    if plan is None:
        plan = make_distributed_plan(tensor, mesh, method=method,
                                     weights=weights, device=device)
    elif plan.method != method:
        raise ValueError(
            f"distributed plan was built for method {plan.method!r}, "
            f"got method={method!r}; rebuild with make_distributed_plan")
    elif weights is not None:
        raise ValueError(
            "pass weights to make_distributed_plan (they are sharded into "
            "the plan); a prebuilt plan already carries its weights")
    mesh = plan.mesh
    N = tensor.nmodes
    shapes = tuple(int(s) for s in tensor.shape)
    check_every = max(1, int(check_every))
    solver = resolve_solver(solver, mesh.device)

    if init_state is not None:
        host_state = init_state
    elif spec is not None and spec.init_state_host is not None:
        host_state = spec.init_state_host(tensor.shape, rank, seed)
    else:
        host_state = _default_init_state_host(tensor.shape, rank, seed)
    state = state_from_reference(*host_state, device=mesh.device)
    collectives = resolve_collectives(plan, collective)
    mode_data, fit_data = _collect_dist_data(plan, collectives)

    n_blocks, rem = divmod(n_iters, check_every)
    block = functools.partial(_build_sweep_block, "segment", N, rank, shapes,
                              None, solver)
    fn_k = block(check_every, method, mesh, collectives) if n_blocks else None
    fn_rem = block(rem, method, mesh, collectives) if rem else None

    shard_nnz = [int(m.nnz_per_dev) for m in plan.modes]
    fits_dev: list = []
    host_syncs = 0
    last_fit = -np.inf
    it = 0
    tr = obs_trace.sink()
    for b in range(n_blocks + (1 if rem else 0)):
        k = check_every if b < n_blocks else rem
        fn = fn_k if b < n_blocks else fn_rem
        start = state
        with (obs_trace.NULL if tr is None else
              tr.span("dist.window", cat="dist", method=method,
                      kappa=mesh.size, window=b, sweeps=k,
                      shard_nnz=shard_nnz)):
            state, fits_blk, ok = fn(start, mode_data, fit_data)
            f, healthy = window_read(mesh, fits_blk[-1], ok)
            host_syncs += 1
            if not healthy:
                state, fits_blk, _ = fn(start, mode_data, fit_data,
                                        rescue=True)
                f, _ = window_read(mesh, fits_blk[-1], None)
                host_syncs += 1
        fits_dev.append(fits_blk)
        it += k
        if verbose and mesh.rank == 0:
            print(f"  ALS iter {it:3d}: fit={f:.6f} (distributed)")
        if abs(f - last_fit) < tol:
            break
        last_fit = f

    host_syncs += 1                             # final materialization
    fits = torch.cat(fits_dev).tolist() if fits_dev else []
    return CPDResult(
        factors=[F.cpu().numpy() for F in state[0]],
        weights=state[2].cpu().numpy().astype(np.float64),
        fits=fits,
        iters=it,
        mttkrp_seconds=0.0,
        total_seconds=obs_clock.now() - t_start,
        host_syncs=host_syncs,
        engine="distributed",
        method=method,
    )
