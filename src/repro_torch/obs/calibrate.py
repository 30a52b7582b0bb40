"""Cost-model-vs-measured calibration (port of ``repro.obs.calibrate``).

  * ``measure_mode_seconds``   -- warm per-mode MTTKRP wall time of a
    backend ('slab' runs the Hopper kernel), read back out of tracer
    spans.  On the card each span closes only after a
    ``torch.cuda.synchronize()`` inside it, so it times the work and not
    its launch.
  * ``measure_shard_imbalance`` -- per-mode load-imbalance factor (max /
    mean shard time) under a kappa-way partition, timed serially and
    unpadded on the host in numpy, as the reference does, beside the
    partitioner's own nnz-count prediction.
  * ``measure_compile_steady`` -- runs the fused driver under the active
    tracer and splits the first ``als.window`` span (which includes the
    window function's build) from the median warm window; the build
    ledger says whether a build landed there.
  * ``calibrate_tensor``       -- one dataset end to end: per-backend
    predicted-vs-observed rows (``predict_fn`` injected by the caller)
    plus one per-mode imbalance row, in the reference's row schema.

The port adds the calibration of its Hopper tile model
(``kernels.ops.estimate_pack_cost``):

  * ``measure_pack_candidates`` -- packs one mode at each candidate
    ``(block_rows, tile)`` and times the slab kernel on it (device time
    per call by CUDA events on the card, host time on the CPU), beside
    the model's counts;
  * ``fit_pack_cost`` -- fits the model's memory rate and per-chunk time
    to such timings (least squares in relative error).
"""
from __future__ import annotations

import functools
import statistics
from typing import Callable

import numpy as np
import torch

from ..core import als_device
from ..core.coo import SparseTensor
from ..core.layout import build_mode_layout
from ..core.load_balance import partition_mode
from ..core.mttkrp import make_plan
from ..device import resolve_device
from ..kernels import ops as kops
from ..kernels import mttkrp_slab as ks
from . import trace as obs_trace
from .clock import now as _now
from .ledger import LEDGER

DEFAULT_MESH_KAPPA = 8   # the reference's "8-virtual-device mesh" width


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Per-mode measured MTTKRP (device path, through the tracer)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mode_mttkrp_fn(backend: str, nmodes: int, rank: int,
                    shapes: tuple[int, ...], slab_meta: tuple | None, d: int):
    """Single-mode MTTKRP on the shared substrate (the kernels every
    engine runs; 'slab' is the Hopper kernel).  Registered in the build
    ledger like any other cached function."""
    one = als_device._build_one_mttkrp(backend, nmodes, shapes, slab_meta)

    def run(mode_data, factors):
        return one(d, mode_data, factors)

    return LEDGER.register(
        "calibrate_mode", (backend, nmodes, rank, shapes, slab_meta, "mode", d),
        run)


def _random_factors(shapes, rank: int, seed: int, device):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((I, rank)).astype(np.float32),
                            device=device) for I in shapes]


def _span_seconds(tr, start_idx: int, name: str) -> list[float]:
    """Durations (s) of spans named ``name`` recorded since start_idx."""
    return [r["dur_us"] / 1e6 for r in tr.records()[start_idx:]
            if r.get("kind") == "span" and r["name"] == name]


def measure_mode_seconds(tensor: SparseTensor, rank: int, backend: str,
                         *, reps: int = 3, seed: int = 0,
                         dataset: str = "?", device="cuda") -> list[float]:
    """Warm wall seconds of ONE MTTKRP per mode (best of ``reps``),
    measured via ``calibrate.mode_mttkrp`` spans on the active tracer (a
    private timer only when tracing is off).  The span (or timer) closes
    after the device has finished the call."""
    dev = resolve_device(device)
    tr = obs_trace.active()
    N = tensor.nmodes
    shapes = tuple(int(s) for s in tensor.shape)
    plan = make_plan(tensor, 1, device=dev)
    mode_data_all, slab_meta = als_device._collect_mode_data(plan, backend,
                                                             rank)
    factors = _random_factors(shapes, rank, seed, dev)
    out = []
    for d in range(N):
        fn = _mode_mttkrp_fn(backend, N, rank, shapes, slab_meta, d)
        fn(mode_data_all[d], factors)                       # warm
        _sync(dev)
        best = None
        for r in range(reps):
            if tr is None:
                t0 = _now()
                fn(mode_data_all[d], factors)
                _sync(dev)
                dt = _now() - t0
            else:
                i0 = len(tr.records())
                with tr.span("calibrate.mode_mttkrp", cat="calibrate",
                             dataset=dataset, backend=backend, mode=d,
                             rep=r, nnz=tensor.nnz):
                    fn(mode_data_all[d], factors)
                    _sync(dev)
                dt = _span_seconds(tr, i0, "calibrate.mode_mttkrp")[-1]
            best = dt if best is None else min(best, dt)
        out.append(float(best))
    return out


# ---------------------------------------------------------------------------
# Measured per-shard load imbalance (serial, unpadded, host numpy)
# ---------------------------------------------------------------------------


def _numpy_shard_mttkrp(idx, rows, vals, in_factors, rank: int):
    """Segmented MTTKRP of one shard's (sorted-row) slice in numpy: work
    scales with the shard's real nnz, which makes its wall time a
    faithful load proxy."""
    if len(vals) == 0:
        return np.zeros((0, rank), np.float32)
    acc = vals[:, None] * in_factors[0][idx[:, 0]]
    for j in range(1, idx.shape[1]):
        acc = acc * in_factors[j][idx[:, j]]
    starts = np.concatenate(
        [[0], np.flatnonzero(np.diff(rows)) + 1]).astype(np.int64)
    return np.add.reduceat(acc, starts, axis=0)


def measure_shard_imbalance(tensor: SparseTensor, rank: int, *,
                            kappa: int = DEFAULT_MESH_KAPPA,
                            reps: int = 20, seed: int = 0,
                            dataset: str = "?") -> list[dict]:
    """Per-mode measured load-imbalance factor under a kappa-way partition:
    each shard's segmented MTTKRP timed serially on the host over
    ``reps`` repetitions, ``max/mean`` shard time beside the
    partitioner's nnz-count prediction.  One span per mode carries both."""
    rng = np.random.default_rng(seed)
    shapes = tuple(int(s) for s in tensor.shape)
    in_factors_all = [rng.standard_normal((I, rank)).astype(np.float32)
                      for I in shapes]
    rows_out = []
    for d in range(tensor.nmodes):
        lay = build_mode_layout(tensor, d, kappa)
        part = partition_mode(tensor, d, kappa, scheme=lay.scheme)
        in_modes = lay.input_modes()
        facs = [in_factors_all[w] for w in in_modes]
        off = lay.part_offsets
        with obs_trace.span("calibrate.imbalance", cat="calibrate",
                            dataset=dataset, mode=d, kappa=kappa,
                            scheme=lay.scheme.name) as sp:
            times = []
            for p in range(kappa):
                s, e = int(off[p]), int(off[p + 1])
                idx = lay.indices[s:e][:, in_modes]
                rws = lay.rows[s:e]
                vls = lay.values[s:e].astype(np.float32)
                _numpy_shard_mttkrp(idx, rws, vls, facs, rank)  # warm caches
                t0 = _now()
                for _ in range(reps):
                    _numpy_shard_mttkrp(idx, rws, vls, facs, rank)
                times.append((_now() - t0) / reps)
            times_arr = np.asarray(times)
            mean = float(times_arr.mean())
            measured = float(times_arr.max() / mean) if mean > 0 else 1.0
            predicted = float(part.imbalance())
            sp.set(measured_imbalance=round(measured, 4),
                   nnz_imbalance=round(predicted, 4))
        rows_out.append({
            "mode": d,
            "scheme": lay.scheme.name,
            "shard_nnz": [int(x) for x in np.diff(off)],
            "measured_imbalance": measured,
            "nnz_imbalance": predicted,
            "mean_shard_s": mean,
            "max_shard_s": float(times_arr.max()),
        })
    return rows_out


# ---------------------------------------------------------------------------
# Build vs steady-state split (from als.window spans)
# ---------------------------------------------------------------------------


def measure_compile_steady(tensor: SparseTensor, rank: int, backend: str,
                           *, check_every: int = 2, n_windows: int = 4,
                           seed: int = 0, device="cuda") -> dict:
    """Run the fused driver under the active tracer and split the first
    ``als.window`` span (which holds the window function's build, when
    its key is new) from the median warm window.  Each window span ends
    with the window's host read, so it covers the device work.
    ``sweep_traces`` is the build ledger's count of sweep blocks built
    during the run."""
    tr = obs_trace.active()
    if tr is None:
        raise RuntimeError(
            "measure_compile_steady needs an active tracer "
            "(obs.trace.enable/capture)")
    i0 = len(tr.records())
    lstats0 = LEDGER.stats("sweep_block")
    als_device.cpd_als_fused(
        tensor, rank, n_iters=check_every * n_windows, tol=-1.0,
        check_every=check_every, backend=backend, seed=seed, device=device)
    lstats1 = LEDGER.stats("sweep_block")
    windows = _span_seconds(tr, i0, "als.window")
    if not windows:
        raise RuntimeError("fused driver emitted no als.window spans")
    cold = windows[0]
    warm = float(np.median(windows[1:])) if len(windows) > 1 else cold
    return {
        "cold_window_s": float(cold),
        "steady_window_s": warm,
        "compile_overhead_s": float(max(cold - warm, 0.0)),
        "windows": len(windows),
        "sweep_traces": lstats1["traces"] - lstats0["traces"],
    }


# ---------------------------------------------------------------------------
# One dataset end to end
# ---------------------------------------------------------------------------


def calibrate_tensor(
    name: str,
    tensor: SparseTensor,
    *,
    rank: int = 32,
    backends: tuple[str, ...] = ("slab", "segment"),
    predict_fn: Callable[[SparseTensor, int, str], float] | None = None,
    kappa: int = DEFAULT_MESH_KAPPA,
    reps: int = 3,
    imbalance_reps: int = 20,
    seed: int = 0,
    device="cuda",
) -> list[dict]:
    """Calibrate one dataset: per-backend predicted-vs-observed rows plus
    one per-mode imbalance row, in the reference's row schema.

    ``predict_fn(tensor, mode, backend) -> seconds`` is the cost model
    under test, injected by the caller.  Without it the prediction fields
    are None and the row is measurement-only.
    """
    rows: list[dict] = []
    N = tensor.nmodes
    for backend in backends:
        measured = measure_mode_seconds(
            tensor, rank, backend, reps=reps, seed=seed, dataset=name,
            device=device)
        per_mode = []
        pred_total = 0.0 if predict_fn is not None else None
        for d in range(N):
            pred = (float(predict_fn(tensor, d, backend))
                    if predict_fn is not None else None)
            if pred is not None:
                pred_total += pred
            per_mode.append({
                "mode": d,
                "predicted_s": pred,
                "measured_s": measured[d],
                "ratio": (pred / measured[d]
                          if pred is not None and measured[d] > 0 else None),
            })
        meas_total = float(sum(measured))
        split = measure_compile_steady(tensor, rank, backend, seed=seed,
                                       device=device)
        rows.append({
            "name": f"obs/{name}/{backend}",
            "section": "ratio",
            "dataset": name,
            "backend": backend,
            "shape": list(int(s) for s in tensor.shape),
            "nnz": int(tensor.nnz),
            "rank": int(rank),
            "predicted_s": pred_total,
            "measured_s": meas_total,
            "predicted_over_observed": (
                pred_total / meas_total
                if pred_total is not None and meas_total > 0 else None),
            "per_mode": per_mode,
            **split,
        })
    imb = measure_shard_imbalance(tensor, rank, kappa=kappa,
                                  reps=imbalance_reps, seed=seed,
                                  dataset=name)
    rows.append({
        "name": f"obs/{name}/imbalance",
        "section": "imbalance",
        "dataset": name,
        "kappa": int(kappa),
        "shape": list(int(s) for s in tensor.shape),
        "nnz": int(tensor.nnz),
        "per_mode": imb,
        "max_measured_imbalance": max(r["measured_imbalance"] for r in imb),
        "max_nnz_imbalance": max(r["nnz_imbalance"] for r in imb),
    })
    return rows


# ---------------------------------------------------------------------------
# The Hopper tile model: timed candidates and the fit
# ---------------------------------------------------------------------------


def _seconds_per_call(fn, reps: int, device: torch.device) -> float:
    """Device seconds per call over ``reps`` calls queued back to back
    (CUDA events, ``slab_ablation.cuda_ms``) on the card; the median
    host time of a call on the CPU."""
    if device.type == "cuda":
        from ..kernels.slab_ablation import cuda_ms

        return cuda_ms(fn, reps) / 1e3
    fn()
    times = []
    for _ in range(reps):
        t0 = _now()
        fn()
        times.append(_now() - t0)
    return statistics.median(times)


def measure_pack_candidates(layout, rank: int, candidates=None, *,
                            reps: int = 21, seed: int = 0, dataset: str = "?",
                            device="cuda") -> list[dict]:
    """The slab kernel timed on one mode's layout packed at each candidate
    ``(block_rows, tile)`` (default ``kops.tile_candidates()``), at the
    rank block the model gives it; infeasible candidates are skipped.
    Each row is ``kops.estimate_pack_cost``'s dict (at its default
    constants) plus ``measured_s``, ``slabs`` (what ``pack_layout``
    made), ``pack_s`` and the mode.  A ``calibrate.tile`` span per
    candidate carries the time."""
    dev = resolve_device(device)
    smem = ks.shared_memory_per_block(dev)
    in_modes = layout.input_modes()
    rng = np.random.default_rng(seed)
    in_f = [torch.as_tensor(
        rng.standard_normal((int(layout.shape[w]), rank)).astype(np.float32),
        device=dev) for w in in_modes]
    rows = []
    for br, t in (kops.tile_candidates() if candidates is None else candidates):
        est = kops.estimate_pack_cost(layout, br, t, rank, smem_limit=smem)
        if not est["smem_ok"]:
            continue
        t0 = _now()
        p = kops.pack_layout(layout, block_rows=br, tile=t)
        pack_s = _now() - t0
        args = (torch.as_tensor(p.idx_packed, device=dev),
                torch.as_tensor(p.vals_packed, device=dev),
                torch.as_tensor(p.lrows_packed, device=dev),
                torch.as_tensor(p.rb_of, device=dev))
        chunks = ks.slab_chunks(p.rb_of, p.num_row_blocks, dev)

        def call():
            return ks.mttkrp_slab(*args, in_f, chunks=chunks,
                                  num_row_blocks=p.num_row_blocks,
                                  block_rows=br, tile=t,
                                  rank_block=est["rank_block"])

        with obs_trace.span("calibrate.tile", cat="calibrate", dataset=dataset,
                            mode=layout.mode, block_rows=br, tile=t) as sp:
            seconds = _seconds_per_call(call, reps, dev)
            sp.set(measured_s=seconds)
        rows.append({**est, "mode": layout.mode, "slabs": p.num_slabs,
                     "pack_s": pack_s, "measured_s": seconds})
        del args, chunks
    return rows


def fit_pack_cost(rows: list[dict]) -> dict:
    """``{"bytes_per_s", "chunk_s"}`` of ``estimate_pack_cost`` fitted to
    timed candidates (``measure_pack_candidates`` rows): least squares of
    ``bytes / bytes_per_s + chunks * rank blocks * chunk_s`` against
    ``measured_s`` in relative error, both terms held nonnegative (a term
    the fit would make negative is dropped and the other refitted)."""
    rows = [r for r in rows if r["measured_s"] > 0]
    if not rows:
        raise ValueError("no timed candidates to fit")
    y = np.array([r["measured_s"] for r in rows], dtype=np.float64)
    X = np.array([[r["bytes"], r["chunks"] * r["num_rank_blocks"]]
                  for r in rows], dtype=np.float64) / y[:, None]
    ones = np.ones(len(rows))

    def solve(cols):
        coef = np.zeros(2)
        if cols:
            coef[cols] = np.linalg.lstsq(X[:, cols], ones, rcond=None)[0]
        return coef

    coef = solve([0, 1])
    if coef.min() < 0:
        fits = [solve([c]) for c in (0, 1)]
        fits = [c for c in fits if c.min() >= 0]
        coef = min(fits, key=lambda c: float(np.sum((X @ c - ones) ** 2)),
                   default=np.zeros(2))
    inv_bw, chunk_s = float(coef[0]), float(coef[1])
    return {"bytes_per_s": 1.0 / inv_bw if inv_bw > 0 else float("inf"),
            "chunk_s": chunk_s}
