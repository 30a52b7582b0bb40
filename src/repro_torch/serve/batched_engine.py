"""Batched ALS engine on one device (port of ``repro.serve.batched_engine``,
``mesh=None``).

One small tensor cannot fill the card, so the service decomposes B
bucket-mates (same shape, one nnz cap, one method; see ``serve.buckets``)
in lockstep: every sweep runs, per mode, ONE launch of the batched MTTKRP
kernel for all B lanes (``kernels.mttkrp_slab.mttkrp_slab_batched``, the
counterpart of the reference's ``jax.vmap`` over the Pallas kernel), then
each lane's update and fit on its own tensors (``core.als_device.
build_lane_sweep``).  A ``check_every`` window of sweeps is queued with no
host read:

  * per-lane freeze masks: a lane that reached its own ``n_iters`` or
    converged keeps its state (``torch.where`` on the device) while its
    bucket-mates sweep on, so batching never changes a result;
  * convergence is judged on the device at the window boundary against
    the previous boundary's fit, the fused engine's rule, per lane;
  * one on-device solve flag for the whole batch rides with the window's
    single host read (the active mask); a flagged window reruns from its
    start with the pinv rescue;
  * window functions are cached per (bucket shape, nnz cap, B, rank,
    backend, solver, window, method); ``batched_cache_stats()`` counts.

Prepare / execute seam.  ``prepare_batch`` (the host half) builds every
input of a batch on the host and, on the card, uploads it from pinned
buffers on a copy stream of the engine's own, recording an event when the
copies are queued.  ``execute_prepared`` (the device half) runs on the
engine's compute stream, which waits on that event before its first
launch; the staged tensors are marked as used by the compute stream so
the caching allocator cannot hand their memory out early.  The scheduler's
double-buffered dispatch therefore uploads flush N+1 while flush N's
kernels run.  Both halves enter the engine's device and stream
themselves, so either may run on any thread.  ``density`` (an observed
per-bucket row-density profile from ``serve.metrics``) reaches the bucket
plan (``core.plan.plan_bucket``).

Each lane computes exactly what the one-lane sweep computes on its data,
so a request's result does not depend on B or on its bucket-mates, and on
the slab backend equals the fused engine's under the bucket's plan.

Packing.  On the slab backend every bucket-mate is packed to the bucket
plan's static slab cap (``core.plan.plan_bucket``), so the slab arrays
stack along a leading lane dimension.  plain and nncp pack the UNPADDED
tensors (slab-cap padding replaces nnz padding and adds exactly +0.0);
the masked method packs the PADDED tensors, whose weight-0 entries are
exact no-ops, so that the residual scatter has one canonical order of
``nnz_cap`` entries per lane.  The segment and coo backends keep one set
of mode data per lane and run the lanes' MTTKRPs in turn.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from ..convert import state_from_reference
from ..core import als_device
from ..core import plan as plan_mod
from ..core.coo import SparseTensor
from ..core.cpd import CPDResult
from ..core.layout import build_all_mode_layouts
from ..core.mttkrp import make_plan
from ..device import resolve_device
from ..kernels.mttkrp_slab import shared_memory_per_block, stack_chunks
from ..kernels.ops import pack_layout
from ..obs import clock as obs_clock
from ..obs import trace as obs_trace
from ..obs.ledger import LEDGER
from .buckets import pad_tensor, pad_weights, repeat_pad

_BATCH_BACKENDS = ("slab", "segment", "coo")


def _freeze(active, new, old):
    """Lane state ``new`` where the lane is active, else ``old`` (on the
    device; ``active`` is a 0-d bool tensor)."""
    return (tuple(torch.where(active, n, o) for n, o in zip(new[0], old[0])),
            tuple(torch.where(active, n, o) for n, o in zip(new[1], old[1])),
            torch.where(active, new[2], old[2]))


def _tree_map(fn, obj):
    """``obj`` with ``fn`` applied to every tensor in it (tuples, lists
    and dataclasses rebuilt)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(fn, o) for o in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def _make_window_runner(backend: str, nmodes: int, rank: int,
                        shapes: tuple[int, ...], solver: str, block: int,
                        slab_meta: tuple | None, method: str):
    """``run_block(carry, mode_data_all, fit_data, tol_b, max_iters_b,
    rescue=False) -> (carry, fits (block, B), ok)``: ``block`` lockstep
    sweeps with per-lane freezing, then the window-boundary convergence
    test.  ``carry = (lane states, active (B,) bool, last_fit (B,),
    done (B,) int32)``.  ``ok`` is the batch's solve flag over the sweeps
    in which each lane was active (None for a method without a solve)."""
    sweep = als_device.build_lane_sweep(backend, nmodes, rank, shapes,
                                        slab_meta, solver, method,
                                        batched=True)

    def run_block(carry, mode_data_all, fit_data, tol_b, max_iters_b,
                  rescue=False):
        states, active, last_fit, done = carry
        fit_ref = last_fit       # fit at the previous window boundary
        fits, oks = [], []
        for _ in range(block):
            new_states, lane_fits, lane_oks = sweep(states, mode_data_all,
                                                    fit_data, rescue)
            states = [_freeze(active[b], new, old) for b, (new, old)
                      in enumerate(zip(new_states, states))]
            if lane_oks[0] is not None:
                oks.append(torch.stack([ok | ~active[b] for b, ok
                                        in enumerate(lane_oks)]).all())
            last_fit = torch.where(active, torch.stack(lane_fits), last_fit)
            done = done + active.to(torch.int32)
            active = active & (done < max_iters_b)
            fits.append(last_fit)
        active = active & ~(torch.abs(last_fit - fit_ref) < tol_b)
        ok = torch.stack(oks).all() if oks else None
        return (states, active, last_fit, done), torch.stack(fits), ok

    return run_block


@functools.lru_cache(maxsize=None)
def _build_batched_block(backend: str, nmodes: int, rank: int,
                         shapes: tuple[int, ...], nnz_cap: int, batch: int,
                         solver: str, block: int, slab_meta: tuple | None,
                         method: str):
    """Cached window function of one (bucket, B, window, method) class;
    ``nnz_cap`` and ``batch`` are in the key so the cache counts one entry
    per class, as the reference's executable cache does.  Each build
    registers in the build ledger (kind ``batched_block``)."""
    return LEDGER.register(
        "batched_block",
        (backend, nmodes, rank, shapes, "cap", nnz_cap, "B", batch,
         "block", block, slab_meta, solver, "method", method),
        _make_window_runner(backend, nmodes, rank, shapes, solver, block,
                            slab_meta, method))


def batched_cache_stats():
    """(hits, misses, currsize) of the batched window-function cache."""
    info = _build_batched_block.cache_info()
    return {"hits": info.hits, "misses": info.misses,
            "currsize": info.currsize}


class BatchedEngine:
    """Decomposes same-bucket tensors in lockstep on one device.

    ``backend``: 'slab' (the batched kernel), 'segment' or 'coo'.
    ``batch_quantum``: a batch is filled up to a multiple of it by
    repeating its last request (``repeat_pad``; the repeated lanes are
    discarded), so streams of varying batch size reuse fewer window
    functions.  ``device`` defaults to the card and raises without it."""

    def __init__(self, rank: int, *, kappa: int = 1, backend: str = "slab",
                 check_every: int = 4, solver: str = "auto",
                 batch_quantum: int = 1, device="cuda"):
        if backend not in _BATCH_BACKENDS:
            raise ValueError(
                f"batched engine supports {_BATCH_BACKENDS}, got {backend!r}")
        self.rank = int(rank)
        self.kappa = int(kappa)
        self.backend = backend
        self.check_every = max(1, int(check_every))
        self.device = resolve_device(device)
        self.solver = als_device.resolve_solver(solver, self.device)
        self.batch_quantum = max(1, int(batch_quantum))
        # Single device: the scheduler reads these where the reference's
        # pod path would name its mesh.
        self.mesh = None
        self.num_devices = 1
        # On the card: batches are built on the host, uploaded on the copy
        # stream and run on the compute stream (see the module docstring).
        cuda = self.device.type == "cuda"
        self._host = torch.device("cpu") if cuda else self.device
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None

    # -- data staging -------------------------------------------------------

    def bucket_plan(self, shape: tuple[int, ...], nnz_cap: int,
                    density: tuple | None = None) -> plan_mod.PartitionPlan:
        """The static plan a (shape, nnz_cap) bucket runs under, shared with
        the fused engine (``make_plan(t, kappa, partition=...)``).  Its slab
        caps and tilings are a function of the bucket alone, so every
        bucket-mate packs to the same array shapes.  ``density`` moves
        only the plan's segment partitioning (``core.plan``)."""
        return plan_mod.plan_bucket(
            tuple(int(s) for s in shape), int(nnz_cap), self.rank, self.kappa,
            smem_limit=shared_memory_per_block(self.device), density=density)

    def _stack_slab(self, source: list[SparseTensor], nnz_cap: int,
                    structural: bool, density, dev):
        """Pack each source tensor to the bucket plan's slab cap and stack
        the packings along a leading lane dimension, as tensors on
        ``dev``.  ``structural=True`` (masked) ships the layout
        permutation and the value scatter instead of baked values."""
        N = source[0].nmodes
        bplan = self.bucket_plan(tuple(source[0].shape), nnz_cap, density)
        lanes = [[] for _ in range(N)]
        for t in source:
            for d, lay in enumerate(build_all_mode_layouts(t, self.kappa)):
                mp = bplan.modes[d]
                lanes[d].append((lay, pack_layout(
                    lay, block_rows=mp.block_rows, tile=mp.tile,
                    num_slabs_cap=mp.slab_cap)))

        def stacked(arrays, dtype=None):
            out = np.stack(arrays)
            return torch.as_tensor(out if dtype is None else out.astype(dtype),
                                   device=dev)

        mode_data_all = []
        for d in range(N):
            lays, packs = zip(*lanes[d])
            common = (stacked([p.idx_packed for p in packs]),
                      stacked([p.lrows_packed for p in packs]),
                      stacked([p.rb_of for p in packs]),
                      stack_chunks([p.rb_of for p in packs],
                                   packs[0].num_row_blocks, dev),
                      [torch.as_tensor(lay.row_perm.astype(np.int64), device=dev)
                       for lay in lays])
            if structural:
                mode_data_all.append(common + (
                    stacked([lay.perm for lay in lays], np.int64),
                    stacked([p.val_scatter for p in packs], np.int64)))
            else:
                idxp, lrowsp, rb_of, chunks, row_perms = common
                valsp = stacked([p.weighted_vals() for p in packs])
                mode_data_all.append((idxp, valsp, lrowsp, rb_of, chunks,
                                      row_perms))
        return tuple(mode_data_all), bplan.slab_meta()

    def _lane_mode_data(self, source: list[SparseTensor], structural: bool,
                        dev):
        """Per-lane mode data of the segment and coo backends, indexed
        ``[mode][lane]``."""
        N = source[0].nmodes
        per_lane = []
        for t in source:
            if self.backend == "coo":
                idx = torch.as_tensor(t.indices, device=dev)
                coo = ((idx,) if structural else
                       (idx, torch.as_tensor(t.values.astype(np.float32),
                                             device=dev)))
                per_lane.append((coo,) * N)
                continue
            plan = make_plan(t, self.kappa, device=dev)
            collect = (als_device.collect_structural_mode_data if structural
                       else als_device._collect_mode_data)
            per_lane.append(collect(plan, self.backend, self.rank)[0])
        return tuple([lane[d] for lane in per_lane] for d in range(N))

    def _stack_batch(self, tensors: list[SparseTensor], nnz_cap: int,
                     spec, weights: Sequence | None, density, dev):
        """``(mode_data_all, fit_data per lane, slab_meta)`` of a batch, as
        tensors on ``dev``."""
        structural = spec is not None and spec.valued_mode_data
        if structural:
            source = [pad_tensor(t, nnz_cap) for t in tensors]
        else:
            source = tensors
        if spec is not None and spec.weighted_fit:
            # Observation weights: the request's own (default 1) on real
            # entries, 0 on nnz padding.
            if weights is None:
                weights = [None] * len(tensors)
            fit_data = []
            for t, padded, w in zip(tensors, source, weights):
                base = (np.ones(t.nnz, np.float32) if w is None
                        else als_device.normalize_entry_weights(
                            als_device.validate_entry_weights(t.nnz, w)))
                fit_data.append(spec.make_fit_data(
                    padded, pad_weights(base, nnz_cap), dev))
        else:
            fit_data = [als_device.make_fit_data(t, dev) for t in source]
        if self.backend == "slab":
            mode_data_all, slab_meta = self._stack_slab(
                source, nnz_cap, structural, density, dev)
            return mode_data_all, fit_data, slab_meta
        return self._lane_mode_data(source, structural, dev), fit_data, None

    # -- driver -------------------------------------------------------------

    def prepare_batch(
        self,
        tensors: Sequence[SparseTensor],
        *,
        n_iters: int | Sequence[int] = 25,
        tol: float | Sequence[float] = 1e-5,
        seeds: Sequence[int] | None = None,
        nnz_cap: int | None = None,
        method: str = "cp",
        init_states: Sequence[tuple | None] | None = None,
        weights: Sequence | None = None,
        density: tuple | None = None,
    ) -> "_PreparedBatch | None":
        """Host half of a batch decomposition: validation, batch-quantum
        padding, packing, init states, then the upload (see the module
        docstring).  Returns None for an empty batch; ``execute_prepared``
        runs the result.  ``density`` reaches the bucket plan."""
        tensors = list(tensors)
        if not tensors:
            return None
        spec = als_device._method_spec(method)
        if weights is not None and any(w is not None for w in weights) and (
                spec is None or not spec.weighted_fit):
            raise ValueError(
                f"per-entry weights require a weighted-fit method "
                f"(e.g. 'masked'), got method={method!r}")
        t_start = obs_clock.now()
        requested = len(tensors)
        shape = tuple(int(s) for s in tensors[0].shape)
        for t in tensors:
            if tuple(t.shape) != shape:
                raise ValueError(
                    f"batch mixes shapes {shape} and {tuple(t.shape)}; "
                    f"bucket before batching")
        cap = (int(nnz_cap) if nnz_cap is not None
               else max(t.nnz for t in tensors))
        if seeds is None:
            seeds = [0] * requested
        if len(seeds) != requested:
            raise ValueError("seeds must match batch size")
        if init_states is not None and len(init_states) != requested:
            raise ValueError("init_states must match batch size")
        if weights is not None and len(weights) != requested:
            raise ValueError("weights must match batch size")
        n_iters_b = list(np.broadcast_to(np.asarray(n_iters, np.int32),
                                         (requested,)))
        tol_b = list(np.broadcast_to(np.asarray(tol, np.float32),
                                     (requested,)))
        B = -(-requested // self.batch_quantum) * self.batch_quantum
        if B > requested:
            tensors, seeds = repeat_pad(tensors, B), repeat_pad(seeds, B)
            n_iters_b, tol_b = repeat_pad(n_iters_b, B), repeat_pad(tol_b, B)
            if init_states is not None:
                init_states = repeat_pad(init_states, B)
            if weights is not None:
                weights = repeat_pad(weights, B)

        host = self._host
        mode_data_all, fit_data, slab_meta = self._stack_batch(
            tensors, cap, spec, weights, density, host)
        init_fn = (spec.init_state_host if spec is not None
                   and spec.init_state_host is not None
                   else als_device.init_state_host)
        states = [
            state_from_reference(
                *(init_states[i] if init_states is not None
                  and init_states[i] is not None
                  else init_fn(shape, self.rank, int(seeds[i]))),
                device=host)
            for i in range(B)]
        carry = (states,
                 torch.ones((B,), dtype=torch.bool, device=host),
                 torch.full((B,), -torch.inf, dtype=torch.float32, device=host),
                 torch.zeros((B,), dtype=torch.int32, device=host))
        prep = _PreparedBatch(
            requested=requested, batch=B, shape=shape, cap=cap, method=method,
            carry=carry, mode_data_all=mode_data_all, fit_data=fit_data,
            tol_dev=torch.as_tensor(np.asarray(tol_b, np.float32), device=host),
            max_iters_dev=torch.as_tensor(np.asarray(n_iters_b, np.int32),
                                          device=host),
            max_iters=int(max(n_iters_b)), slab_meta=slab_meta,
            t_start=t_start)
        return self._upload(prep)

    def _upload(self, prep: "_PreparedBatch") -> "_PreparedBatch":
        """Stage a host-built batch on the card: pinned buffers, copies
        queued on the copy stream, an event recorded after the last one."""
        if self.stream is None:
            return prep
        dev = self.device

        def stage(t):
            out = t.pin_memory().to(dev, non_blocking=True)
            # allocated on the copy stream, used on the compute stream
            out.record_stream(self.stream)
            return out

        with torch.cuda.device(dev), torch.cuda.stream(self._copy_stream):
            staged = _tree_map(stage, prep)
            staged.ready = torch.cuda.Event()
            staged.ready.record(self._copy_stream)
        return staged

    def execute_prepared(self, prep: "_PreparedBatch | None"
                         ) -> list[CPDResult]:
        """Device half: run a prepared batch and materialize its results.
        On the card it runs on the engine's compute stream, after the
        batch's uploads."""
        if prep is None:
            return []
        if self.stream is None:
            return self._execute_loop(prep)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.stream.wait_event(prep.ready)
            return self._execute_loop(prep)

    def decompose_batch(
        self,
        tensors: Sequence[SparseTensor],
        *,
        n_iters: int | Sequence[int] = 25,
        tol: float | Sequence[float] = 1e-5,
        seeds: Sequence[int] | None = None,
        nnz_cap: int | None = None,
        method: str = "cp",
        init_states: Sequence[tuple | None] | None = None,
        weights: Sequence | None = None,
        density: tuple | None = None,
    ) -> list[CPDResult]:
        """Decompose B same-shape tensors in lockstep.

        ``n_iters`` / ``tol`` / ``seeds`` may be scalars or per-tensor
        sequences.  ``method`` is shared by the batch.  ``init_states``
        warm-starts individual requests (``None`` entries take the
        method's seeded init).  ``weights`` is an optional per-tensor list
        of entry-weight vectors (canonical order; ``None`` means all ones)
        for weighted-fit methods.  ``nnz_cap`` defaults to the largest
        request's nnz.  ``density`` (per-mode observed row-density
        profiles) reaches the bucket plan.  Results carry per-tensor
        factors, fits and iters; ``total_seconds`` and ``host_syncs`` are
        the batch's."""
        return self.execute_prepared(self.prepare_batch(
            tensors, n_iters=n_iters, tol=tol, seeds=seeds, nnz_cap=nnz_cap,
            method=method, init_states=init_states, weights=weights,
            density=density))

    def _execute_loop(self, prep: "_PreparedBatch") -> list[CPDResult]:
        """The window loop: one host read per window (the active mask and
        the solve flag, in one transfer), plus one at the end."""
        carry = prep.carry
        B, N = prep.batch, len(prep.shape)
        fits_dev: list = []
        host_syncs = 0
        it = 0
        tr = obs_trace.active()
        while it < prep.max_iters:
            k = min(self.check_every, prep.max_iters - it)
            fn = _build_batched_block(
                self.backend, N, self.rank, prep.shape, prep.cap, B,
                self.solver, k, prep.slab_meta, prep.method)
            start = carry
            with (obs_trace.NULL if tr is None else
                  tr.span("batched.window", cat="serve", backend=self.backend,
                          B=B, sweeps=k, method=prep.method)):
                carry, fits_blk, ok = fn(start, prep.mode_data_all,
                                         prep.fit_data, prep.tol_dev,
                                         prep.max_iters_dev)
                flags = carry[1].to(torch.float32)
                if ok is not None:
                    flags = torch.cat([flags, ok.to(torch.float32)[None]])
                flags = flags.tolist()
                host_syncs += 1
                if ok is not None and not flags[-1]:
                    carry, fits_blk, _ = fn(start, prep.mode_data_all,
                                            prep.fit_data, prep.tol_dev,
                                            prep.max_iters_dev, rescue=True)
                    flags = carry[1].to(torch.float32).tolist()
                    host_syncs += 1
            fits_dev.append(fits_blk)
            it += k
            if not any(flags[:B]):
                break

        host_syncs += 1              # final materialization
        fits = (torch.cat(fits_dev) if fits_dev else
                torch.zeros((0, B), dtype=torch.float32, device=self.device))
        return self._materialize(prep, carry, fits, host_syncs)

    def _materialize(self, prep: "_PreparedBatch", carry, fits,
                     host_syncs: int) -> list[CPDResult]:
        """Everything the results need in ONE device-to-host transfer;
        repeated batch-quantum lanes are dropped here."""
        states, _, _, done = carry
        N = len(prep.shape)
        parts = [F.reshape(-1) for st in states[:prep.requested] for F in st[0]]
        parts += [st[2] for st in states[:prep.requested]]
        parts += [done.to(torch.float32), fits.reshape(-1)]
        flat = torch.cat(parts).cpu().numpy()
        wall = obs_clock.now() - prep.t_start

        sizes = [p.numel() for p in parts]
        chunks = np.split(flat, np.cumsum(sizes)[:-1])
        R, B = self.rank, prep.batch
        done_h = chunks[-2].astype(np.int64)
        fits_h = chunks[-1].reshape(-1, B)
        results = []
        for i in range(prep.requested):
            ni = int(done_h[i])
            results.append(CPDResult(
                factors=[chunks[i * N + d].reshape(prep.shape[d], R).copy()
                         for d in range(N)],
                weights=chunks[prep.requested * N + i].astype(np.float64),
                fits=[float(f) for f in fits_h[:ni, i]],
                iters=ni,
                mttkrp_seconds=0.0,
                total_seconds=wall,
                host_syncs=host_syncs,
                engine="batched",
                method=prep.method,
            ))
        return results


@dataclasses.dataclass
class _PreparedBatch:
    """Host-assembled batch, ready to run (see ``prepare_batch``).
    ``batch`` >= ``requested`` under a batch quantum; only the first
    ``requested`` lanes become results."""

    requested: int
    batch: int
    shape: tuple[int, ...]
    cap: int
    method: str
    carry: tuple
    mode_data_all: tuple
    fit_data: list
    tol_dev: torch.Tensor
    max_iters_dev: torch.Tensor
    max_iters: int
    slab_meta: tuple | None
    t_start: float
    ready: object = None      # CUDA event after the uploads (card only)
