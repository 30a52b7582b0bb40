#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root; needs one card)

Builds the port's CUDA kernel from ``src/repro_torch/csrc`` into ``build/``
and holds its three entries (value-baked, valued, batched) against their
plain PyTorch versions at the paths' shapes.  Then it drives, each with
the launch counts set to 0 just before and read just after:

  main_path -- sparse CPD-ALS on the chicago-shaped FROSTT stand-in
               (24744 x 24 x 77 x 32, 5,330,673 nonzeros, rank 16);
  methods   -- ``cpd_als(method="nncp")`` and ``method="masked"`` with
               seeded observation weights on the same tensor;
  batched   -- ``BatchedEngine.decompose_batch`` on 8 uber-shaped requests
               (183 x 24 x 1140 x 1717, 827,372 - 4,096 b nonzeros) for
               cp, nncp and masked;
  stream    -- a ``StreamingCP`` cp session on the full uber stand-in
               (3,309,490 nonzeros): a cold start on 3,000,000 shuffled
               entries, then 4 increments of the rest, each with 8,000
               re-observed coordinates; checkpoint and restore midway, one
               increment against the segment backend, a cold refit;
  stream_masked -- a masked session with weights, decay and eviction on
               one uber-shaped request, against the segment backend;
  service   -- ``DecompositionService`` on 16 uber-shaped requests (two
               flushes of 8), synchronous and double-buffered, and one
               streaming increment routed through ``ALSRunner``;

checks each against the port's other backends or its sequential engine,
and times the kernels beside their byte bounds, their plain versions and
one PyTorch library call.  Last comes

  plan      -- the paper's scheme choice on the chicago and uber
               stand-ins at kappa = the card's SM count: per mode the
               threshold rule's scheme, the cost rule's under the
               reference's default profile and under one measured here
               (memory rate from a 1 GiB copy, update rate from an
               ``index_add_``), and the slab kernel's time under each
               forced scheme; the fig-5 memory report beside the bytes
               the plan allocates; a ``.tns`` round trip of an uber-shaped
               request; ``calibrate_tensor`` and the Hopper tile model
               fitted to timed tilings; no builds on a repeated shape.

Prints one JSON line per phase, then the
``{"kernels": ...}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
then exits non-zero and prints no ``ok`` line.  It imports nothing of JAX.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores
RANK = 16
TIMED_LAUNCHES = 21
# The batched phase's bucket: 8 requests of uber's shape, each with the
# nnz of frostt_like("uber", scale=0.25) less 4096 per lane.
UBER_SHAPE = (183, 24, 1140, 1717)
UBER_NNZ = 827_372
LANE_STEP = 4_096
LANES = 8
METHODS = ("cp", "nncp", "masked")
# The stream phase: the first STREAM_START of uber's shuffled entries, then
# the rest in STREAM_INCREMENTS increments, each with STREAM_REPEATS
# coordinates the session already holds (their values add).
STREAM_START = 3_000_000
STREAM_INCREMENTS = 4
STREAM_REPEATS = 8_000
# The masked stream: lane 0 of the uber bucket, MASKED_START entries first.
MASKED_START = 600_000
MASKED_DECAY, MASKED_FLOOR = 0.8, 0.1
SERVICE_REQUESTS = 16
SERVICE_CAP = 962_965         # the 16 requests' bucket under growth 1.25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def low_rank_full(shape, rank, seed):
    """Every coordinate of an exactly rank-``rank`` CP tensor, stored as COO."""
    import numpy as np
    from repro_torch.core.coo import SparseTensor

    rng = np.random.default_rng(seed)
    F = [rng.standard_normal((I, rank)).astype(np.float32) for I in shape]
    dense = np.einsum("ir,jr,kr->ijk", *F)
    idx = np.indices(shape).reshape(len(shape), -1).T.astype(np.int32)
    return SparseTensor(idx, dense.reshape(-1).astype(np.float32), shape)


def reset_launches(ks) -> None:
    for entry in ks.LAUNCHES:
        ks.LAUNCHES[entry] = 0


def observation_weights(np, nnz: int, seed: int):
    """Seeded confidences from U[0, 1], with 5% of them set to 0."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 1.0, nnz).astype(np.float32)
    w[rng.choice(nnz, size=nnz // 20, replace=False)] = 0.0
    return w


def largest_drop(fits) -> float:
    """How far any fit falls below the one before (0 if none does)."""
    return max([0.0] + [a - b for a, b in zip(fits, fits[1:])])


def fit_gap(np, a, b) -> float:
    return float(np.max(np.abs(np.array(a) - np.array(b))))


def library_mttkrp(torch, np, indices, shape, d, values, in_f):
    """``torch.sparse.mm`` of the mode-d CSR matricization (``values`` in
    canonical order) and the dense Khatri-Rao of ``in_f``, as a callable,
    plus the Khatri-Rao's bytes.  Building either is outside the call."""
    dev = in_f[0].device
    idx = torch.as_tensor(indices, device=dev).long()
    others = [w for w in range(len(shape)) if w != d]
    cols = torch.zeros(idx.shape[0], dtype=torch.long, device=dev)
    for w in others:
        cols = cols * shape[w] + idx[:, w]
    ncols = int(np.prod([shape[w] for w in others]))
    order = torch.sparse_coo_tensor(
        torch.stack([idx[:, d], cols]),
        torch.arange(idx.shape[0], dtype=torch.float64, device=dev),
        (shape[d], ncols), check_invariants=False).coalesce()
    csr = order.to_sparse_csr()
    vals = torch.as_tensor(values, device=dev)[csr.values().long()]
    csr = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(), vals,
                                  (shape[d], ncols))
    krp = in_f[0]
    for f in in_f[1:]:
        krp = (krp[:, None, :] * f[None, :, :]).reshape(-1, f.shape[1])
    return (lambda: torch.sparse.mm(csr, krp)), krp.numel() * 4


def slab_bound(slots, W, chunk_ints, factor_rows, out_rows, value_bytes=None):
    """The least time of one slab MTTKRP: bytes (each input read once, each
    output written once) over the card's memory rate, or its float32
    operations over the float32 rate, whichever is larger.  The inputs are
    the packed indices and local rows, the values (``value_bytes``;
    default the packed float32 values), the chunk tables, the factors."""
    if value_bytes is None:
        value_bytes = slots * 4
    nbytes = (slots * (W + 1) * 4 + value_bytes + chunk_ints * 4
              + factor_rows * RANK * 4 + out_rows * RANK * 4)
    ops = slots * RANK * (W + 1)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "bytes": nbytes, "ops": ops}


def dev_us(e) -> float:
    """Device time of one ``key_averages()`` entry, in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


def device_idle(torch, fn, clock):
    """Wall time, device busy time, idle share and top kernels of one
    ``fn()`` under ``torch.profiler`` (``fn`` has run once before)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = clock.now()
        fn()
        torch.cuda.synchronize()
        wall_ms = (clock.now() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms if kernels else None,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
            "top": [{"name": e.key[:60], "count": e.count, "ms": dev_us(e) / 1e3}
                    for e in top]}


def pass_times(torch, fn, calls: int):
    """Device time per call of the slab kernel's pass one
    (``chunk_tiles_kernel``) and pass two (both ``sum_ranges_kernel``
    launches), from ``torch.profiler``'s ``key_averages()`` over ``calls``
    calls of ``fn`` (made after the CUDA-event timing of the same calls)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {"pass_one_ms": 0.0, "pass_two_ms": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = ("pass_one_ms" if "chunk_tiles_kernel" in e.key
               else "pass_two_ms" if "sum_ranges_kernel" in e.key else None)
        if key:
            split[key] += dev_us(e) / 1e3 / calls
    check(split["pass_one_ms"] > 0 and split["pass_two_ms"] > 0,
          f"the profiler saw no slab kernel: {split}")
    return split


def launch_facts(ks, lib, dev, rank, rank_block, block_rows, in_modes, shape):
    """The launch shape of pass one for this mode: the input modes whose
    factors it stages in shared memory, columns per thread, walkers,
    shared memory and blocks resident per SM."""
    cfg = ks.launch_config(rank, rank_block, block_rows,
                           [shape[w] for w in in_modes],
                           smem_limit=ks.shared_memory_per_block(dev))
    return {"staged_inputs": [w for i, w in enumerate(in_modes)
                              if cfg.staged_mask >> i & 1],
            "cols": cfg.cols, "walkers": cfg.walkers, "smem": cfg.smem,
            "blocks_per_sm": ks.blocks_per_sm(lib, cfg, len(in_modes), False, dev)}


def host_ms(torch, clock, fn, calls: int) -> float:
    """Host time per call of ``fn`` (what it takes to queue its work),
    over ``calls`` calls queued back to back."""
    torch.cuda.synchronize()
    t0 = clock.now()
    for _ in range(calls):
        fn()
    per_call = (clock.now() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return per_call


def mttkrp_f64(torch, idx_packed, vals_packed, lrows_packed, rb_of, factors, *,
               num_row_blocks, block_rows, tile):
    """The slab kernel's plain arithmetic (``mttkrp_slab_plain``) carried
    out in float64.  The masked method's residuals correlate with the
    factors, so a row's terms share a sign and its float32 sums drift
    with their length: mode 1 of the chicago stand-in sums 222K of them
    per row, and the float32 plain version's atomic adds then err by more
    than the kernel's chunked sums.  The valued entry is held against this."""
    prod = vals_packed[0].double()[:, None]
    for w, fac in enumerate(factors):
        prod = prod * fac.double().index_select(0, idx_packed[w].long())
    rows = (lrows_packed[0].long()
            + torch.repeat_interleave(rb_of.long(), tile) * block_rows)
    out = torch.zeros((num_row_blocks * block_rows, prod.shape[1]),
                      dtype=torch.float64, device=prod.device)
    return out.index_add_(0, rows, prod)


def eng_block(eng, prep, block: int):
    """The engine's cached window function of ``block`` sweeps for ``prep``."""
    from repro_torch.serve.batched_engine import _build_batched_block

    return _build_batched_block(eng.backend, len(prep.shape), eng.rank, prep.shape,
                                prep.cap, prep.batch, eng.solver, block,
                                prep.slab_meta, prep.method)


def device_run(torch, clock, fn):
    """``(fn(), wall s, device ms, slab-kernel ms)``: the wall time of
    ``fn()`` to a synchronize, every CUDA activity it queued, and the slab
    kernel's two passes alone, by ``torch.profiler`` (its set-up and the
    event processing are outside the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = clock.now()
        out = fn()
        torch.cuda.synchronize()
        wall = clock.now() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel = [e for e in events if "chunk_tiles_kernel" in e.key
              or "sum_ranges_kernel" in e.key]
    return (out, wall, sum(dev_us(e) for e in events) / 1e3,
            sum(dev_us(e) for e in kernel) / 1e3)


def expected_session(np, streamed, shape):
    """Sorted unique linearized keys of everything streamed so far, with
    their summed values in float64: what the session must hold."""
    from repro_torch.core.coo import _linearize

    idx = np.concatenate([x.indices for x in streamed])
    vals = np.concatenate([x.values for x in streamed]).astype(np.float64)
    keys, inverse = np.unique(_linearize(idx, shape), return_inverse=True)
    return keys, np.bincount(inverse.reshape(-1), weights=vals)


def check_session(np, session, streamed, what):
    from repro_torch.core.coo import _linearize

    keys, sums = expected_session(np, streamed, session.tensor.shape)
    got = _linearize(session.tensor.indices, session.tensor.shape)
    check(np.array_equal(got, keys), f"{what}: session coordinates differ from "
                                     f"the sorted unique streamed ones")
    err = float(np.max(np.abs(session.tensor.values - sums)))
    check(err <= 1e-5, f"{what}: session values off by {err}")
    return err


def increment(torch, clock, trace, session, delta, **kw):
    """One ``update`` under the tracer and ``torch.profiler``: its result
    and wall, merge, window (queueing plus the window reads) and host
    preparation seconds, device and slab-kernel ms, and padding share."""
    merged0 = session.merge_seconds
    with trace.capture() as tr:
        res, wall, dev_ms, kernel_ms = device_run(
            torch, clock, lambda: session.update(delta, **kw))
    windows = sum(r["dur_us"] for r in tr.records() if r["name"] == "als.window") / 1e6
    merge_s = session.merge_seconds - merged0
    cap, nnz = session.bucket_cap, session.tensor.nnz
    return res, {"nnz": nnz, "bucket_cap": cap, "padding_share": (cap - nnz) / cap,
                 "wall_s": wall, "merge_s": merge_s, "windows_s": windows,
                 "host_prep_s": wall - merge_s - windows, "device_ms": dev_ms,
                 "kernel_ms": kernel_ms, "iters": res.iters, "fit": res.fits[-1]}


def stream_phase(torch, np, clock, ks, trace):
    """A cp session on the full uber stand-in through the slab kernel."""
    import shutil

    from repro_torch.convert import stream_state_from_reference
    from repro_torch.core.als_device import cpd_als_fused, sweep_cache_stats
    from repro_torch.core.coo import SparseTensor, frostt_like
    from repro_torch.methods import StreamingCP

    t0 = clock.now()
    full = frostt_like("uber", scale=1.0)
    shape = tuple(full.shape)
    rng = np.random.default_rng(17)
    order = rng.permutation(full.nnz)
    idx, vals = full.indices[order], full.values[order]
    start = SparseTensor(idx[:STREAM_START], vals[:STREAM_START], shape)
    deltas = []
    for part in np.array_split(np.arange(STREAM_START, full.nnz), STREAM_INCREMENTS):
        held = rng.choice(part[0], size=STREAM_REPEATS, replace=False)
        deltas.append(SparseTensor(
            np.concatenate([idx[part], idx[held]]),
            np.concatenate([vals[part],
                            rng.standard_normal(STREAM_REPEATS).astype(np.float32)]),
            shape))
    gen_s = clock.now() - t0

    reset_launches(ks)
    session = StreamingCP(RANK, backend="slab", check_every=2, refine_iters=2)
    t0 = clock.now()
    first = session.start(start, n_iters=10)
    start_s = clock.now() - t0
    sweeps = first.iters
    streamed, rows, value_errs = [start], [], []
    ckpt = ROOT / "build" / "stream_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    seg_fits = None
    for k, delta in enumerate(deltas):
        if k == STREAM_INCREMENTS - 1:
            # The last increment on segment, from the same session state.
            seg = stream_state_from_reference(
                session, StreamingCP(RANK, backend="segment", check_every=2,
                                     refine_iters=2))
            slab_launches = dict(ks.LAUNCHES)
            seg_fits = seg.update(delta).fits
            check(ks.LAUNCHES == slab_launches, "the segment increment launched the kernel")
            del seg
        cap0, misses0 = session.bucket_cap, sweep_cache_stats()["misses"]
        res, row = increment(torch, clock, trace, session, delta)
        sweeps += res.iters
        row["cache_misses"] = sweep_cache_stats()["misses"] - misses0
        if session.bucket_cap == cap0:
            check(row["cache_misses"] == 0,
                  f"increment {k + 1} inside its bucket missed the window cache")
        streamed.append(delta)
        value_errs.append(check_session(np, session, streamed, f"increment {k + 1}"))
        rows.append(row)
        if k == 1:
            session.save(ckpt)
    launches = ks.LAUNCHES["mttkrp_slab"]
    check(launches == 4 * sweeps,
          f"stream: {launches} mttkrp_slab launches for {sweeps} sweeps of 4 modes")
    seg_gap = fit_gap(np, res.fits, seg_fits)
    check(seg_gap <= 1e-5, f"stream: slab increment differs from segment by {seg_gap}")

    restored = StreamingCP.restore(ckpt)
    check(restored.increments == 2 and restored.bucket_cap == rows[1]["bucket_cap"],
          "stream: restored session counters differ")
    for delta in deltas[2:]:
        rres = restored.update(delta)
    shutil.rmtree(ckpt, ignore_errors=True)
    restore_gap = max(fit_gap(np, rres.fits, res.fits),
                      max(float(np.max(np.abs(a - b)))
                          for a, b in zip(rres.factors, res.factors)))
    check(restore_gap <= 1e-6, f"stream: restored session differs by {restore_gap}")

    cold, refit_s, refit_dev_ms, _ = device_run(
        torch, clock, lambda: cpd_als_fused(session.tensor, RANK, n_iters=10,
                                            check_every=2))
    mean_inc = sum(r["wall_s"] for r in rows) / len(rows)
    out = {"phase": "stream", "shape": list(shape), "nnz": full.nnz, "rank": RANK,
           "start_nnz": STREAM_START, "increments": STREAM_INCREMENTS,
           "repeats_per_increment": STREAM_REPEATS, "generate_s": gen_s,
           "start_s": start_s, "start_iters": first.iters, "launches": launches,
           "sweeps": sweeps, "per_increment": rows, "max_value_err": max(value_errs),
           "segment_fit_gap": seg_gap, "restore_gap": restore_gap,
           "cold_refit_s": refit_s, "cold_refit_device_ms": refit_dev_ms,
           "cold_refit_iters": cold.iters,
           "mean_increment_s": mean_inc, "refit_over_increment": refit_s / mean_inc,
           "stats": session.stats()}
    del session, restored, full, idx, vals, deltas, streamed
    torch.cuda.empty_cache()
    return out


def stream_masked_phase(torch, np, clock, ks, trace, lane):
    """A masked session with weights, decay and eviction on one uber-shaped
    request, on slab and on segment."""
    from repro_torch.core.coo import SparseTensor
    from repro_torch.core.plan import session_cap
    from repro_torch.methods import StreamingCP
    from repro_torch.methods.streaming import _canonical, _merge_sorted

    shape = tuple(lane.shape)
    order = np.random.default_rng(23).permutation(lane.nnz)
    idx, vals = lane.indices[order], lane.values[order]
    w = observation_weights(np, lane.nnz, seed=11)
    parts = [np.arange(MASKED_START)] + np.array_split(
        np.arange(MASKED_START, lane.nnz), STREAM_INCREMENTS)

    def piece(p):
        return SparseTensor(idx[p], vals[p], shape), w[p]

    sessions, fits, rows = {}, {}, []
    for backend in ("slab", "segment"):
        reset_launches(ks)
        s = StreamingCP(RANK, method="masked", backend=backend, check_every=2,
                        refine_iters=2, decay=MASKED_DECAY, weight_floor=MASKED_FLOOR)
        x, wx = piece(parts[0])
        res = s.start(x, n_iters=10, weights=wx)
        sweeps, fits[backend] = res.iters, [res.fits]
        for p in parts[1:]:
            x, wx = piece(p)
            if backend == "slab":
                res, row = increment(torch, clock, trace, s, x, weights=wx)
                rows.append(row)
            else:
                res = s.update(x, weights=wx)
            sweeps += res.iters
            fits[backend].append(res.fits)
        if backend == "slab":
            launches = dict(ks.LAUNCHES)
            check(launches["mttkrp_slab_valued"] == 4 * sweeps
                  and launches["mttkrp_slab"] == 0,
                  f"stream_masked: launches {launches} for {sweeps} sweeps")
        sessions[backend] = s
    gap = max(fit_gap(np, a, b) for a, b in zip(fits["slab"], fits["segment"]))
    check(gap <= 1e-5, f"stream_masked: slab fits differ from segment by {gap}")

    # Survivors by hand: decay every increment, evict below the floor
    # when a merge would cross into a larger bucket.
    s = sessions["slab"]
    pol = s.policy
    k_, i_, v_, w_ = _canonical(idx[parts[0]], vals[parts[0]], w[parts[0]], shape)
    cap = session_cap(len(k_), 0, pol)
    for p in parts[1:]:
        d = _canonical(idx[p], vals[p], w[p], shape)
        k_, i_, v_, w_ = _merge_sorted(k_, i_, v_, w_ * np.float32(MASKED_DECAY), *d)
        if session_cap(len(k_), cap, pol) > cap:
            keep = w_ >= np.float32(MASKED_FLOOR)
            k_, i_, v_, w_ = k_[keep], i_[keep], v_[keep], w_[keep]
        cap = session_cap(len(k_), cap, pol)
    check(s.evictions > 0, "stream_masked: nothing was evicted")
    check(s.evictions == sessions["segment"].evictions, "eviction counts differ")
    survivors_equal = (np.array_equal(s.tensor.indices, i_)
                       and np.array_equal(s.tensor.values, v_)
                       and np.array_equal(s.session_weights, w_))
    check(survivors_equal, "stream_masked: survivors differ from the hand-made set")
    out = {"phase": "stream_masked", "shape": list(shape), "nnz": lane.nnz,
           "start_nnz": MASKED_START, "increments": STREAM_INCREMENTS,
           "decay": MASKED_DECAY, "weight_floor": MASKED_FLOOR,
           "weights": "U[0,1], 5% set to 0, seed 11", "launches": launches,
           "sweeps": sweeps, "evictions": s.evictions, "final_nnz": s.tensor.nnz,
           "survivors_bitwise": survivors_equal, "segment_fit_gap": gap,
           "per_increment": rows, "stats": s.stats()}
    del sessions, s
    torch.cuda.empty_cache()
    return out


def service_phase(torch, np, clock, ks, lanes, lane_results):
    """16 uber-shaped requests through ``DecompositionService``, synchronous
    and double-buffered, and one streaming increment through ``ALSRunner``."""
    from repro_torch.core.coo import SparseTensor, random_sparse
    from repro_torch.runtime import ALSRunner
    from repro_torch.serve import BucketPolicy, DecompositionService

    t0 = clock.now()
    reqs = list(lanes) + [random_sparse(UBER_SHAPE, UBER_NNZ - LANE_STEP * (b % LANES), seed=b,
                                        distribution="powerlaw")
                          for b in range(LANES, SERVICE_REQUESTS)]
    gen_s = clock.now() - t0
    policy = BucketPolicy(mode="geometric", growth=1.25)
    caps = {policy.bucket_for(x).nnz_cap for x in reqs}
    check(caps == {SERVICE_CAP}, f"service: requests fall in buckets {caps}")

    runs = {}
    for db in (False, True):
        # max_wait_s is out of reach: only max_batch triggers flush here.
        svc = DecompositionService(RANK, backend="slab", max_batch=LANES, check_every=5,
                                   policy=policy, max_wait_s=1e9, double_buffer=db)

        def drive():
            t_begin = clock.now()
            futs = [svc.submit(x, n_iters=10, seed=b) for b, x in enumerate(reqs)]
            svc.drain()
            return [f.result() for f in futs], clock.now() - t_begin

        reset_launches(ks)
        if db:
            (results, wall), _, busy_ms, _ = device_run(torch, clock, drive)
        else:
            (results, wall), busy_ms = drive(), None
        launches = dict(ks.LAUNCHES)
        snap = svc.snapshot()
        events = list(svc.scheduler.metrics.batches)
        check(snap["batches"] == 2 and [e.batch_size for e in events] == [LANES, LANES]
              and snap["flush_triggers"]["max_batch"] == 2,
              f"service (double_buffer={db}): flushes {[e.batch_size for e in events]}")
        check(launches["mttkrp_slab_batched"] == 2 * 40
              and launches["mttkrp_slab"] == launches["mttkrp_slab_valued"] == 0,
              f"service (double_buffer={db}): launches {launches}, not 40 per flush")
        check(all(r.host_syncs == 3 and r.iters == 10 for r in results),
              f"service (double_buffer={db}): host syncs "
              f"{sorted({r.host_syncs for r in results})}, not 3 per batch")
        runs[db] = {"results": results, "wall_s": wall, "snapshot": snap,
                    "launches": launches["mttkrp_slab_batched"],
                    "device_busy_ms": busy_ms}
    sync, dbuf = runs[False]["results"], runs[True]["results"]
    bitwise = all(a.fits == b.fits and np.array_equal(a.weights, b.weights)
                  and all(np.array_equal(x, y) for x, y in zip(a.factors, b.factors))
                  for a, b in zip(sync, dbuf))
    check(bitwise, "service: double-buffered results differ from synchronous ones")
    lane_gap = max(fit_gap(np, sync[b].fits, lane_results[b].fits) for b in range(LANES))
    check(lane_gap <= 1e-5, f"service: requests 0-7 differ from the batched phase by {lane_gap}")

    # One streaming increment routed through the runner's service.
    runner = ALSRunner(RANK, backend="slab")
    session = runner.open_stream(session_id="smoke")
    x = lanes[0]
    session.start(SparseTensor(x.indices[:800_000], x.values[:800_000], x.shape), n_iters=4)
    reset_launches(ks)
    res = session.update(SparseTensor(x.indices[800_000:], x.values[800_000:], x.shape))
    runner_launches = ks.LAUNCHES["mttkrp_slab_batched"]
    gauge = runner.service.snapshot()["streams"]["smoke"]
    check(res.engine == "batched" and runner_launches == 4 * res.iters
          and gauge["increments"] == 1 and gauge["nnz"] == session.tensor.nnz,
          f"runner stream: engine {res.engine}, {runner_launches} launches, gauge {gauge}")

    def summary(db):
        run = runs[db]
        snap, wall = run["snapshot"], run["wall_s"]
        disp = snap["dispatch"]
        out = {"wall_s": wall, "decompositions_per_s": SERVICE_REQUESTS / wall,
               "latency_p50_s": snap["latency_p50_s"],
               "latency_p99_s": snap["latency_p99_s"],
               "setup_s_per_flush": disp["assembly_s"] / disp["count"],
               "execute_s_per_flush": disp["execute_s"] / disp["count"],
               "overlap_s": disp["overlap_s"],
               "overlap_fraction": disp["overlap_fraction"],
               "launches": run["launches"], "cache_misses": snap["cache_misses"]}
        if run["device_busy_ms"] is not None:
            out["device_busy_ms"] = run["device_busy_ms"]
            out["device_idle_share"] = 1.0 - run["device_busy_ms"] / (wall * 1e3)
        return out

    return {"phase": "service", "requests": SERVICE_REQUESTS, "shape": list(UBER_SHAPE),
            "nnz_cap": SERVICE_CAP, "rank": RANK, "sweeps": 10, "check_every": 5,
            "generate_s": gen_s, "sync": summary(False), "double_buffer": summary(True),
            "double_buffer_bitwise": bitwise, "lane_fit_gap_vs_batched": lane_gap,
            "runner_stream": {"launches": runner_launches, "iters": res.iters,
                              "gauge": gauge, "fit": res.fits[-1]}}


def kernel_vs_plain_err(torch, ks, data, in_f, meta, what) -> tuple[float, float]:
    """``(max abs error, tolerance)`` of the slab kernel against its plain
    version on one mode's device data ``(idx, vals, lrows, rb_of, chunks,
    row_perm)`` at ``meta = (row blocks, block_rows, tile, rank_block)``.
    Tolerance: float32 sums of up to ~2.2e5 terms taken in two orders
    differ by a small multiple of eps times the absolute sum (about 1.5e-7
    of it measured on the H100); hold them to 1e-5 of it."""
    idxp, valsp, lrowsp, rb_of, chunks, _ = data
    nrb, br, tile, rblk = meta
    kw = dict(num_row_blocks=nrb, block_rows=br, tile=tile)
    k = ks.mttkrp_slab(idxp, valsp, lrowsp, rb_of, in_f, chunks=chunks,
                       rank_block=rblk, **kw)
    plain = ks.mttkrp_slab_plain(idxp, valsp, lrowsp, rb_of, in_f, **kw)
    mag = ks.mttkrp_slab_plain(idxp, valsp.abs(), lrowsp, rb_of,
                               [f.abs() for f in in_f], **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k).all()), f"{what}: non-finite kernel output")
    return float((k - plain).abs().max()), 1e-5 * float(mag.max())


def measured_profile_bw(torch, dev) -> dict:
    """The card's memory rate from a device-to-device copy of 1 GiB:
    bytes read plus bytes written over the median copy time."""
    n = 2 ** 28                                  # float32: 1 GiB
    src = torch.empty(n, dtype=torch.float32, device=dev).fill_(1.0)
    dst = torch.empty_like(src)
    ms = cuda_ms(torch, lambda: dst.copy_(src), 5)
    del src, dst
    torch.cuda.empty_cache()
    return {"copy_bytes": 4 * n, "copy_ms": ms, "bw": 2 * 4 * n / (ms * 1e-3)}


def atomic_tput(torch, np, t, d, dev) -> float:
    """Shared-output updates per second on the card: an ``index_add_`` of
    nnz x RANK products into an (I_d, RANK) tensor at mode d's rows."""
    rows = torch.as_tensor(t.indices[:, d].astype(np.int64), device=dev)
    src = torch.ones((t.nnz, RANK), dtype=torch.float32, device=dev)
    out = torch.zeros((t.shape[d], RANK), dtype=torch.float32, device=dev)
    ms = cuda_ms(torch, lambda: out.index_add_(0, rows, src), 5)
    del rows, src, out
    return t.nnz * RANK / (ms * 1e-3)


def plan_phase(torch, np, clock, ks, dev, chicago, lane0):
    """The paper's scheme choice on the card: per mode of the chicago and
    uber stand-ins at kappa = the card's SM count, the threshold rule's and
    the cost rule's schemes (the reference's default profile and one
    measured here), and the slab kernel's time under each forced scheme;
    the fig-5 memory report; a ``.tns`` round trip; calibration and the
    Hopper tile model's fit; and the build ledger on a repeated shape."""
    import dataclasses
    import math

    from repro_torch.core.als_device import sweep_trace_stats
    from repro_torch.core.coo import SparseTensor, frostt_like
    from repro_torch.core.cpd import cpd_als
    from repro_torch.core.layout import build_mode_layout, format_memory_report
    from repro_torch.core.load_balance import (DeviceProfile, Scheme, choose_scheme,
                                               scheme_cost)
    from repro_torch.core.mttkrp import make_plan
    from repro_torch.data import read_tns, write_tns
    from repro_torch.kernels import ops as kops
    from repro_torch.obs import LEDGER, calibrate, trace

    t_phase = clock.now()
    props = torch.cuda.get_device_properties(dev)
    kappa = int(props.multi_processor_count)
    default = DeviceProfile()
    bw = measured_profile_bw(torch, dev)
    t0 = clock.now()
    uber = frostt_like("uber", scale=1.0)
    gen_s = clock.now() - t0
    rng = np.random.default_rng(29)
    S1, S2 = Scheme.INDEX_PARTITION, Scheme.NNZ_PARTITION
    reset_launches(ks)
    compare_launches = 0
    rules = ("threshold", "cost_default", "cost_measured")
    tensors, ratios = {}, {r: [] for r in rules}
    memory = None
    for name, t in (("chicago", chicago), ("uber", uber)):
        facs = [torch.as_tensor(rng.standard_normal((I, RANK)).astype(np.float32),
                                device=dev) for I in t.shape]
        t0 = clock.now()
        plans = {1: make_plan(t, kappa, scheme=S1, device=dev),
                 2: make_plan(t, kappa, scheme=S2, device=dev)}
        layouts_s = clock.now() - t0
        t0 = clock.now()
        for sc, p in plans.items():
            if name == "chicago" and sc == 1:
                torch.cuda.synchronize()
                mem0 = torch.cuda.memory_allocated(dev)
            for d in range(t.nmodes):
                p.device_packed(d)
            if name == "chicago" and sc == 1:
                torch.cuda.synchronize()
                grown = torch.cuda.memory_allocated(dev) - mem0
                report = format_memory_report(t, p.layouts)
                memory = {"report": report, "allocated_growth_bytes": grown,
                          "growth_over_copies": grown / report["copies_bytes"],
                          "factors_bytes_rank16": sum(int(I) * RANK * 4
                                                      for I in t.shape)}
        pack_s = clock.now() - t0
        modes = []
        for d in range(t.nmodes):
            row = {"mode": d, "rows": int(t.shape[d]),
                   "atomic_tput": atomic_tput(torch, np, t, d, dev)}
            measured = DeviceProfile(bw=bw["bw"], atomic_tput=row["atomic_tput"],
                                     rank=RANK)
            # scheme_cost partitions the mode on the host: set-up time.
            t0 = clock.now()
            costs = {sc: scheme_cost(t, d, kappa, Scheme(sc), profile=default)
                     for sc in (1, 2)}
            mcosts = {sc: scheme_cost(t, d, kappa, Scheme(sc), profile=measured)
                      for sc in (1, 2)}
            row["cost_s"] = clock.now() - t0
            row["schemes"] = {
                "threshold": choose_scheme(t.shape[d], kappa).value,
                "cost_default": 1 if costs[1] <= costs[2] else 2,
                "cost_measured": 1 if mcosts[1] <= mcosts[2] else 2}
            row["modeled_s"] = {"default": costs, "measured": mcosts}
            calls, metas = {}, {}
            for sc, p in plans.items():
                pk = p.packed(d)
                metas[sc] = (pk.num_row_blocks, pk.block_rows, pk.tile,
                             p.mode_plan(d, RANK).rank_block)
                idxp, valsp, lrowsp, rb_of, chunks, _ = p.device_packed(d)
                in_f = [facs[w] for w in p.layouts[d].input_modes()]
                calls[sc] = functools.partial(
                    ks.mttkrp_slab, idxp, valsp, lrowsp, rb_of, in_f, chunks=chunks,
                    num_row_blocks=pk.num_row_blocks, block_rows=pk.block_rows,
                    tile=pk.tile, rank_block=metas[sc][3])
                row[f"scheme{sc}"] = {"slabs": pk.num_slabs,
                                      "padding_share": pk.pad_fraction}
            # In turns, 1 2 2 1: a difference must hold in both rounds.
            rounds = [(sc, cuda_ms(torch, calls[sc], TIMED_LAUNCHES))
                      for sc in (1, 2, 2, 1)]
            for sc in (1, 2):
                runs = [ms for s, ms in rounds if s == sc]
                row[f"scheme{sc}"].update(ms=sum(runs) / 2, ms_rounds=runs)
            ms1, ms2 = row["scheme1"]["ms"], row["scheme2"]["ms"]
            faster = 1 if ms1 <= ms2 else 2
            row["faster"] = faster
            row["same_order_both_rounds"] = (
                (rounds[0][1] <= rounds[1][1]) == (rounds[3][1] <= rounds[2][1]))
            row["scheme1_over_scheme2"] = ms1 / ms2
            for rule in rules:
                chosen = row["schemes"][rule]
                ratios[rule].append(row[f"scheme{chosen}"]["ms"] / row[f"scheme{faster}"]["ms"])
            row["picked_faster"] = {r: row["schemes"][r] == faster for r in rules}
            if d == 0:
                # The kernel against its plain version on one mode per scheme.
                before = ks.LAUNCHES["mttkrp_slab"]
                for sc, p in plans.items():
                    in_f = [facs[w] for w in p.layouts[d].input_modes()]
                    err, tol = kernel_vs_plain_err(torch, ks, p.device_packed(d),
                                                   in_f, metas[sc], f"plan: {name}")
                    check(err <= tol, f"plan: {name} mode {d} scheme {sc}: "
                                      f"err {err} > tol {tol}")
                    row[f"scheme{sc}"].update(max_abs_err=err, tol=tol)
                compare_launches += ks.LAUNCHES["mttkrp_slab"] - before
            modes.append(row)
        tensors[name] = {"shape": list(t.shape), "nnz": t.nnz,
                         "layouts_s": layouts_s, "pack_s": pack_s, "modes": modes}
        del plans, facs
        torch.cuda.empty_cache()
    geomean = {r: math.exp(sum(math.log(x) for x in v) / len(v))
               for r, v in ratios.items()}

    # -- a .tns round trip of lane 0 of the uber bucket ----------------------
    path = ROOT / "build" / "plan_lane0.tns"
    path.parent.mkdir(exist_ok=True)
    t0 = clock.now()
    write_tns(str(path), lane0)
    write_s = clock.now() - t0
    t0 = clock.now()
    back = read_tns(str(path))
    read_s = clock.now() - t0
    file_bytes = path.stat().st_size
    path.unlink()
    tns_equal = (np.array_equal(back.indices, lane0.indices)
                 and back.indices.dtype == lane0.indices.dtype
                 and back.values.tobytes() == lane0.values.tobytes())
    check(tns_equal, "plan: the .tns round trip changed indices or values")
    inferred = list(back.shape)
    shape_equal = tuple(back.shape) == tuple(lane0.shape)
    if not shape_equal:     # an empty last slice is not in the file
        back = SparseTensor(back.indices, back.values, lane0.shape)
    kw = dict(n_iters=10, check_every=5, seed=0, device="cuda")
    first = cpd_als(lane0, RANK, **kw)
    builds0, sweeps0 = LEDGER.stats(), sweep_trace_stats()
    again = cpd_als(back, RANK, **kw)
    builds1, sweeps1 = LEDGER.stats(), sweep_trace_stats()
    cpd_equal = (first.fits == again.fits
                 and all(np.array_equal(a, b) for a, b in zip(first.factors, again.factors)))
    check(cpd_equal, "plan: cpd_als on the read tensor differs from the original")
    new_builds = builds1["traces"] - builds0["traces"]
    check(new_builds == 0 and sweeps1 == sweeps0,
          f"plan: a repeated shape built {new_builds} functions ({sweeps0} -> {sweeps1})")

    # -- calibration: calibrate_tensor, then the tile model's fit -------------
    t0 = clock.now()
    with trace.capture() as tr:
        cal_rows = calibrate.calibrate_tensor(
            "chicago", chicago, rank=RANK, backends=("slab",), reps=3,
            imbalance_reps=2, device=dev)
    calibrate_s = clock.now() - t0
    ratio_row = cal_rows[0]
    check(all(math.isfinite(m["measured_s"]) and m["measured_s"] > 0
              for m in ratio_row["per_mode"]), "plan: calibrate_tensor timings")
    span_names = sorted({r["name"] for r in tr.records() if r["kind"] == "span"})
    t0 = clock.now()
    tile_layouts = {"chicago": build_mode_layout(chicago, 0, 1),
                    "uber": build_mode_layout(uber, 3, 1)}
    timed = {name: calibrate.measure_pack_candidates(lay, RANK, dataset=name,
                                                     reps=TIMED_LAUNCHES, device=dev)
             for name, lay in tile_layouts.items()}
    tiles_s = clock.now() - t0
    fit = calibrate.fit_pack_cost([r for rows in timed.values() for r in rows])
    # The same fit with the function's bytes alone (``slab_bound``'s count,
    # no partial tiles between the passes), to show what the partials do.
    bare_rows = {name: [{**r, "bytes": r["bytes"] - r["partial_bytes"]} for r in rows]
                 for name, rows in timed.items()}
    bare = calibrate.fit_pack_cost([r for rows in bare_rows.values() for r in rows])
    smem = ks.shared_memory_per_block(dev)
    tiles = {}
    for name, rows in timed.items():
        lay = tile_layouts[name]
        for r in rows:
            after = kops.estimate_pack_cost(lay, r["block_rows"], r["tile"], RANK,
                                            smem_limit=smem, **fit)["cost"]
            r.update(before_ratio=r["cost"] / r["measured_s"],
                     after_ratio=after / r["measured_s"])
        pick = kops.auto_tiles(lay, RANK, smem_limit=smem, **fit)
        by_tiles = {(r["block_rows"], r["tile"]): r for r in rows}
        bare_cost = {(r["block_rows"], r["tile"]): r["bytes"] / bare["bytes_per_s"]
                     + r["chunks"] * r["num_rank_blocks"] * bare["chunk_s"]
                     for r in bare_rows[name]}
        bare_pick = min(bare_cost, key=bare_cost.get)
        check(pick in by_tiles and (128, 256) in by_tiles,
              f"plan: {name}: auto_tiles picked an untimed {pick}")
        tiles[name] = {
            "mode": lay.mode, "rows": lay.num_rows, "nnz": lay.nnz,
            "candidates": [{k: r[k] for k in ("block_rows", "tile", "slabs",
                                               "pad_fraction", "chunks", "bytes",
                                               "rank_block", "measured_s",
                                               "before_ratio", "after_ratio")}
                           for r in rows],
            "before_ratio_range": [min(r["before_ratio"] for r in rows),
                                   max(r["before_ratio"] for r in rows)],
            "after_ratio_range": [min(r["after_ratio"] for r in rows),
                                  max(r["after_ratio"] for r in rows)],
            "auto_tiles": list(pick), "auto_tiles_ms": by_tiles[pick]["measured_s"] * 1e3,
            "bare_pick": list(bare_pick),
            "bare_pick_ms": by_tiles[bare_pick]["measured_s"] * 1e3,
            "bare_after_ratio_range": [
                min(bare_cost[k] / by_tiles[k]["measured_s"] for k in bare_cost),
                max(bare_cost[k] / by_tiles[k]["measured_s"] for k in bare_cost)],
            "default_ms": by_tiles[(128, 256)]["measured_s"] * 1e3,
            "fastest": min(by_tiles, key=lambda k: by_tiles[k]["measured_s"]),
            "fastest_ms": min(r["measured_s"] for r in rows) * 1e3}
    launches = ks.LAUNCHES["mttkrp_slab"] - compare_launches
    return {"phase": "plan", "kappa": kappa, "paper_kappa": 82, "rank": RANK,
            "uber_generate_s": gen_s,
            "default_profile": dataclasses.asdict(default),
            "measured_profile": {**bw, "rank": RANK,
                                 "atomic_tput": "per mode, in tensors.*.modes"},
            "tensors": tensors, "geomean_chosen_over_faster": geomean,
            "memory": memory,
            "tns": {"nnz": lane0.nnz, "file_bytes": file_bytes, "write_s": write_s,
                    "read_s": read_s, "bitwise": tns_equal,
                    "inferred_shape": inferred,
                    "shape_equal": shape_equal, "cpd_bitwise": cpd_equal},
            "ledger": {"new_builds_on_repeat": new_builds, "sweep_trace_stats": sweeps1,
                       "kinds": LEDGER.kinds()},
            "calibrate": {"rows": cal_rows, "spans": span_names, "seconds": calibrate_s},
            "tile_model": {"fit": fit, "bare_fit": bare, "defaults": {
                "bytes_per_s": kops.DATASHEET_BYTES_PER_S, "chunk_s": 0.0},
                "tensors": tiles, "seconds": tiles_s},
            "launches": launches, "compare_launches": compare_launches,
            "phase_s": clock.now() - t_phase}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import als_device
    from repro_torch.core.coo import frostt_like
    from repro_torch.core.cpd import cpd_als
    from repro_torch.core.mttkrp import make_plan
    from repro_torch.core.plan import slab_cap
    from repro_torch.convert import state_from_reference
    from repro_torch.kernels import build, mttkrp_slab as ks
    from repro_torch.kernels.ops import pack_layout
    from repro_torch.obs import clock

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()

    # -- device: versions and the kernel build -----------------------------
    t0 = clock.now()
    build.load_library()
    build_s = clock.now() - t0
    log = build.library_path(build.CSRC / "mttkrp_slab.cu").with_suffix(".log")
    ptxas = build.ptxas_summary(log.read_text()) if log.exists() else []
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas})

    # -- data: the chicago stand-in and its mode layouts --------------------
    t0 = clock.now()
    t = frostt_like("chicago", scale=1.0)
    gen_s = clock.now() - t0
    t0 = clock.now()
    plan = make_plan(t, kappa=1, device=dev)
    for d in range(t.nmodes):
        plan.device_packed(d)
    torch.cuda.synchronize()
    prep_s = clock.now() - t0
    emit({"phase": "data", "shape": list(t.shape), "nnz": t.nnz,
          "generate_s": gen_s, "host_prep_s": prep_s,
          "slabs": [plan.packed(d).num_slabs for d in range(t.nmodes)],
          "row_blocks": [plan.packed(d).num_row_blocks for d in range(t.nmodes)],
          "chunks": [plan.device_packed(d)[4].num_chunks for d in range(t.nmodes)]})

    # -- kernel_vs_plain -----------------------------------------------------
    rng = np.random.default_rng(7)

    def factors_for(rank, dtype=torch.float32):
        return [torch.as_tensor(rng.standard_normal((I, rank)).astype(np.float32),
                                device=dev).to(dtype) for I in t.shape]

    def run_pair(d, facs, rank_block):
        p = plan.packed(d)
        return kernel_vs_plain_err(
            torch, ks, plan.device_packed(d),
            [facs[w] for w in plan.layouts[d].input_modes()],
            (p.num_row_blocks, p.block_rows, p.tile, rank_block), f"mode {d}")

    f16 = factors_for(RANK)
    f33 = factors_for(33)
    fbf = factors_for(RANK, torch.bfloat16)
    modes = []
    for d in range(t.nmodes):
        rb = plan.mode_plan(d, RANK).rank_block
        err, tol = run_pair(d, f16, rb)
        check(err <= tol, f"mode {d} rank {RANK}: err {err} > tol {tol}")
        err33, tol33 = run_pair(d, f33, 16)
        check(err33 <= tol33, f"mode {d} rank 33/rank_block 16: err {err33} > {tol33}")
        errbf, tolbf = run_pair(d, fbf, rb)
        check(errbf <= tolbf, f"mode {d} bf16: err {errbf} > {tolbf}")
        modes.append({"mode": d, "rank_block": rb, "max_abs_err": err, "tol": tol,
                      "r33_rb16_err": err33, "r33_tol": tol33,
                      "bf16_err": errbf, "bf16_tol": tolbf})
    # Cap slabs add exactly +0.0: a slab-capped packing of mode 1 gives
    # bitwise the kernel output of the uncapped one.
    lay = plan.layouts[1]
    p = plan.packed(1)
    cap = slab_cap(lay.num_rows, lay.nnz + 4096, p.block_rows, p.tile)
    pc = pack_layout(lay, block_rows=p.block_rows, tile=p.tile, num_slabs_cap=cap)
    in_f = [f16[w] for w in lay.input_modes()]
    capped = ks.mttkrp_slab(
        torch.as_tensor(pc.idx_packed, device=dev),
        torch.as_tensor(pc.vals_packed, device=dev),
        torch.as_tensor(pc.lrows_packed, device=dev),
        torch.as_tensor(pc.rb_of, device=dev), in_f,
        chunks=ks.slab_chunks(pc.rb_of, pc.num_row_blocks, dev),
        num_row_blocks=pc.num_row_blocks, block_rows=pc.block_rows, tile=pc.tile)
    idxp, valsp, lrowsp, rb_of, chunks, _ = plan.device_packed(1)
    uncapped = ks.mttkrp_slab(idxp, valsp, lrowsp, rb_of, in_f, chunks=chunks,
                              num_row_blocks=p.num_row_blocks,
                              block_rows=p.block_rows, tile=p.tile)
    cap_equal = bool(torch.equal(capped, uncapped))
    check(cap_equal, "slab-capped packing changed the kernel output")
    emit({"phase": "kernel_vs_plain", "modes": modes,
          "cap_slabs": pc.num_slabs - p.num_slabs, "cap_bitwise_equal": cap_equal})

    # -- main_path -----------------------------------------------------------
    reset_launches(ks)
    res = cpd_als(t, RANK, plan=plan, backend="slab", n_iters=10,
                  check_every=5, device="cuda")
    launches = ks.LAUNCHES["mttkrp_slab"]
    check(launches == 40, f"main path launched the kernel {launches} times, not 40")
    check(res.host_syncs == 3, f"host_syncs {res.host_syncs} != 3")
    check(res.iters == 10 and len(res.fits) == 10, "main path did not run 10 sweeps")
    check(all(np.isfinite(F).all() and F.shape == (I, RANK)
              for F, I in zip(res.factors, t.shape)), "bad factors")
    seg = cpd_als(t, RANK, plan=plan, backend="segment", n_iters=10,
                  check_every=5, device="cuda")
    gap = float(np.max(np.abs(np.array(res.fits) - np.array(seg.fits))))
    check(gap <= 1e-5, f"slab fits differ from segment fits by {gap}")

    # One window under sync-debug "error": it must queue without a host read.
    shapes = tuple(t.shape)
    mode_data, meta = als_device._collect_mode_data(plan, "slab", RANK)
    fit_data = als_device.make_fit_data(t, dev)
    window = als_device._build_sweep_block("slab", t.nmodes, RANK, shapes, meta,
                                           "cho", 5)
    state = state_from_reference(*als_device.init_state_host(shapes, RANK, 0),
                                 device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, win_fits, win_ok = window(state, mode_data, fit_data)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bool(win_ok), "solve flagged non-finite in the sync-free window")
    check(abs(float(win_fits[-1]) - res.fits[4]) <= 1e-5, "sync-free window fit differs")

    rec_t = low_rank_full((96, 80, 64), 4, seed=0)
    rec = cpd_als(rec_t, 4, backend="slab", n_iters=50, kappa=4, tol=1e-9,
                  device="cuda")
    check(rec.fits[-1] >= 0.999, f"low-rank recovery fit {rec.fits[-1]}")
    emit({"phase": "main_path", "launches": launches, "host_syncs": res.host_syncs,
          "iters": res.iters, "fits": res.fits, "segment_fits": seg.fits,
          "fit_gap": gap, "total_s": res.total_seconds,
          "segment_total_s": seg.total_seconds, "sync_free_window": True,
          "recovery_shape": [96, 80, 64], "recovery_fit": rec.fits[-1],
          "recovery_iters": rec.iters})

    # -- methods: nncp and masked on the chicago stand-in -------------------
    from repro_torch.core.coo import SparseTensor
    from repro_torch.methods import masked, nncp

    mkw = dict(plan=plan, n_iters=10, check_every=5, device="cuda")
    reset_launches(ks)
    nn = cpd_als(t, RANK, backend="slab", method="nncp", **mkw)
    nn_launches = dict(ks.LAUNCHES)
    check(nn_launches["mttkrp_slab"] == 40,
          f"nncp launched the kernel {nn_launches['mttkrp_slab']} times, not 40")
    check(nn.host_syncs == 3, f"nncp host_syncs {nn.host_syncs} != 3")
    check(all(bool((F >= 0).all()) for F in nn.factors), "nncp factor < 0")
    check(largest_drop(nn.fits) <= 1e-6, f"nncp fit fell: {nn.fits}")
    nn_seg = cpd_als(t, RANK, backend="segment", method="nncp", **mkw)
    nn_gap = fit_gap(np, nn.fits, nn_seg.fits)
    check(nn_gap <= 1e-5, f"nncp slab fits differ from segment by {nn_gap}")

    w = observation_weights(np, t.nnz, seed=11)
    reset_launches(ks)
    mk = cpd_als(t, RANK, backend="slab", method="masked", weights=w, **mkw)
    mk_launches = dict(ks.LAUNCHES)
    check(mk_launches["mttkrp_slab_valued"] == 40 and mk_launches["mttkrp_slab"] == 0,
          f"masked launches {mk_launches}, not 40 valued")
    check(mk.host_syncs == 3, f"masked host_syncs {mk.host_syncs} != 3")
    check(largest_drop(mk.fits) <= 1e-6, f"masked fit fell: {mk.fits}")
    check(all(np.isfinite(F).all() and F.shape == (I, RANK)
              for F, I in zip(mk.factors, t.shape)), "bad masked factors")
    mk_seg = cpd_als(t, RANK, backend="segment", method="masked", weights=w, **mkw)
    mk_gap = fit_gap(np, mk.fits, mk_seg.fits)
    check(mk_gap <= 1e-5, f"masked slab fits differ from segment by {mk_gap}")
    keep = w != 0.0
    t_red = SparseTensor(t.indices[keep], t.values[keep], t.shape)
    red = cpd_als(t_red, RANK, backend="slab", method="masked", weights=w[keep],
                  n_iters=10, check_every=5, device="cuda")
    w0_gap = fit_gap(np, mk.fits, red.fits)
    check(w0_gap <= 1e-5, f"weight-0 entries differ from absent ones by {w0_gap}")

    # One masked window under sync-debug "error": the valued path queues
    # without a host read too.
    smd, smeta = als_device.collect_structural_mode_data(plan, "slab", RANK)
    mfd = masked.make_fit_data(t, w, dev)
    mwindow = als_device._build_sweep_block("slab", t.nmodes, RANK, shapes, smeta,
                                            "cho", 5, "masked")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, mwin_fits, mwin_ok = mwindow(state, smd, mfd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bool(mwin_ok), "masked solve flagged in the sync-free window")
    check(abs(float(mwin_fits[-1]) - mk.fits[4]) <= 1e-5, "masked window fit differs")
    emit({"phase": "methods", "tensor": "chicago", "rank": RANK, "sweeps": 10,
          "nncp": {"launches": nn_launches, "host_syncs": nn.host_syncs,
                   "fits": nn.fits, "segment_fits": nn_seg.fits, "fit_gap": nn_gap,
                   "largest_drop": largest_drop(nn.fits),
                   "min_factor": float(min(F.min() for F in nn.factors)),
                   "total_s": nn.total_seconds},
          "masked": {"launches": mk_launches, "host_syncs": mk.host_syncs,
                     "weights": "U[0,1], 5% set to 0, seed 11",
                     "fits": mk.fits, "segment_fits": mk_seg.fits, "fit_gap": mk_gap,
                     "largest_drop": largest_drop(mk.fits),
                     "weight0_vs_absent_gap": w0_gap, "sync_free_window": True,
                     "total_s": mk.total_seconds}})

    # -- batched: 8 uber-shaped requests through BatchedEngine ------------------
    from repro_torch.core.coo import random_sparse
    from repro_torch.serve import BatchedEngine

    t0 = clock.now()
    lanes = [random_sparse(UBER_SHAPE, UBER_NNZ - LANE_STEP * b, seed=b,
                           distribution="powerlaw") for b in range(LANES)]
    lane_w = [observation_weights(np, x.nnz, seed=100 + b)
              for b, x in enumerate(lanes)]
    cap = max(x.nnz for x in lanes)
    eng = BatchedEngine(RANK, backend="slab", check_every=5)
    bplan = eng.bucket_plan(UBER_SHAPE, cap)
    seq_plans = [make_plan(x, 1, partition=bplan, device=dev) for x in lanes]
    gen_s = clock.now() - t0

    # The batched kernel: lane b bitwise the single launch on every mode.
    prep_cp = eng.prepare_batch(lanes, n_iters=10, seeds=list(range(LANES)))
    rngb = np.random.default_rng(13)
    bfac = [torch.as_tensor(rngb.standard_normal((LANES, I, RANK)).astype(np.float32),
                            device=dev) for I in UBER_SHAPE]
    lane_equal, batched_modes = True, []
    for d in range(len(UBER_SHAPE)):
        idxp, valsp, lrowsp, rb_of, chunks, _ = prep_cp.mode_data_all[d]
        nrb, br, tile, rblk = prep_cp.slab_meta[d]
        in_f = [bfac[w] for w in range(len(UBER_SHAPE)) if w != d]
        kw = dict(num_row_blocks=nrb, block_rows=br, tile=tile)
        out = ks.mttkrp_slab_batched(idxp, valsp, lrowsp, rb_of, in_f,
                                     chunks=chunks, rank_block=rblk, **kw)
        for b in range(LANES):
            one = ks.mttkrp_slab(
                idxp[b], valsp[b], lrowsp[b], rb_of[b], [f[b] for f in in_f],
                chunks=ks.slab_chunks(rb_of[b].cpu().numpy(), nrb, dev),
                rank_block=rblk, **kw)
            lane_equal &= bool(torch.equal(out[b], one))
        plain = ks.mttkrp_slab_batched_plain(idxp, valsp, lrowsp, rb_of, in_f, **kw)
        mag = ks.mttkrp_slab_batched_plain(idxp, valsp.abs(), lrowsp, rb_of,
                                           [f.abs() for f in in_f], **kw)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        tol = 1e-5 * float(mag.max())
        check(err <= tol, f"batched mode {d}: err {err} > tol {tol}")
        batched_modes.append({"mode": d, "max_abs_err": err, "tol": tol})
    check(lane_equal, "a batched lane differs from its single launch")
    del out, plain, mag

    batched, batched_res = {}, {}
    preps = {"cp": prep_cp}
    for method in METHODS:
        wkw = dict(weights=lane_w) if method == "masked" else {}
        if method not in preps:
            preps[method] = eng.prepare_batch(lanes, n_iters=10,
                                              seeds=list(range(LANES)),
                                              method=method, **wkw)
        reset_launches(ks)
        t0 = clock.now()
        res_b = eng.execute_prepared(preps[method])
        run_s = clock.now() - t0
        batched_res[method] = res_b
        b_launches = dict(ks.LAUNCHES)
        rescued = res_b[0].host_syncs - 3
        check(b_launches["mttkrp_slab_batched"] == 40 + rescued * 5 * 4
              and b_launches["mttkrp_slab"] == b_launches["mttkrp_slab_valued"] == 0,
              f"batched {method} launches {b_launches} with {rescued} rescued windows")
        check(rescued == 0, f"batched {method}: {rescued} windows reran under the rescue")
        check(all(r.iters == 10 and np.isfinite(r.fits).all() for r in res_b),
              f"batched {method} did not run 10 finite sweeps")
        gaps = []
        for b, x in enumerate(lanes):
            seq = cpd_als(x, RANK, plan=seq_plans[b], backend="slab", method=method,
                          n_iters=10, check_every=5, seed=b, device="cuda",
                          **({"weights": lane_w[b]} if method == "masked" else {}))
            gaps.append(fit_gap(np, res_b[b].fits, seq.fits))
        check(max(gaps) <= 1e-5, f"batched {method} lanes differ from sequential: {gaps}")
        last = LANES - 1
        one = eng.decompose_batch([lanes[last]], n_iters=10, seeds=[last], nnz_cap=cap,
                                  method=method,
                                  **({"weights": [lane_w[last]]} if method == "masked" else {}))[0]
        b1_equal = (all(np.array_equal(a, c) for a, c in zip(one.factors, res_b[last].factors))
                    and np.array_equal(one.weights, res_b[last].weights))
        check(b1_equal, f"batched {method}: B = 1 and B = {LANES} differ for lane {last}")
        entry = {"launches": b_launches, "host_syncs": res_b[0].host_syncs,
                 "rescued_windows": rescued, "fits_lane0": res_b[0].fits,
                 "max_fit_gap_vs_sequential": max(gaps), "b1_equals_b8": b1_equal,
                 "execute_s": run_s}
        if method != "masked":
            own = eng.decompose_batch([lanes[last]], n_iters=10, seeds=[last],
                                      nnz_cap=lanes[last].nnz, method=method)[0]
            pad_equal = (all(np.array_equal(a, c) for a, c in zip(own.factors, one.factors))
                         and np.array_equal(own.weights, one.weights))
            check(pad_equal, f"batched {method}: padded and unpadded differ")
            entry["padded_equals_unpadded"] = pad_equal
        batched[method] = entry
    batched_launches = sum(batched[m]["launches"]["mttkrp_slab_batched"] for m in METHODS)
    emit({"phase": "batched", "shape": list(UBER_SHAPE), "lanes": LANES,
          "nnz": [x.nnz for x in lanes], "nnz_cap": cap, "rank": RANK, "sweeps": 10,
          "setup_s": gen_s, "plan": bplan.describe(),
          "lane_bitwise_single_launch": lane_equal, "kernel_modes": batched_modes,
          "methods": batched})

    # -- stream, stream_masked, service -------------------------------------------
    from repro_torch.obs import trace

    # The profiler's first use sets up its tracing for seconds: not in a
    # timed increment.
    device_run(torch, clock, lambda: torch.ones(1, device=dev).sum())
    new_phases = {}
    for name, run in (
            ("stream", lambda: stream_phase(torch, np, clock, ks, trace)),
            ("stream_masked", lambda: stream_masked_phase(torch, np, clock, ks, trace,
                                                          lanes[0])),
            ("service", lambda: service_phase(torch, np, clock, ks, lanes,
                                              batched_res["cp"]))):
        t0 = clock.now()
        out = run()
        out["phase_s"] = clock.now() - t0
        new_phases[name] = out
        emit(out)

    # -- times -----------------------------------------------------------------
    # The value-baked entry on the main path's packings, and the valued
    # entry on the masked method's residuals (its 5% weight-0 entries give
    # residuals of exactly +-0.0), per chicago mode.
    lam = torch.ones(RANK, device=dev)
    resid = masked.mttkrp_values(None, f16, lam, mfd)
    per_mode, valued_modes = [], []
    for d in range(t.nmodes):
        idxp, valsp, lrowsp, rb_of, chunks, _ = plan.device_packed(d)
        _, _, _, _, _, perm, scatter = plan.device_structural(d, "slab")
        p = plan.packed(d)
        others = plan.layouts[d].input_modes()
        in_f = [f16[w] for w in others]
        kw = dict(num_row_blocks=p.num_row_blocks, block_rows=p.block_rows,
                  tile=p.tile)
        rb = plan.mode_plan(d, RANK).rank_block
        slots = p.num_slabs * p.tile
        chunk_ints = chunks.numel()
        factor_rows = sum(t.shape[w] for w in others)
        out_rows = p.num_row_blocks * p.block_rows
        bound = slab_bound(slots, len(others), chunk_ints, factor_rows, out_rows)
        baked = functools.partial(ks.mttkrp_slab, idxp, valsp, lrowsp, rb_of, in_f,
                                  chunks=chunks, rank_block=rb, **kw)
        ms = cuda_ms(torch, baked, TIMED_LAUNCHES)
        split = pass_times(torch, baked, TIMED_LAUNCHES)
        facts = launch_facts(ks, build.load_library(), dev, RANK, rb, p.block_rows,
                             others, t.shape)
        host = host_ms(torch, clock, baked, TIMED_LAUNCHES)
        plain_ms = cuda_ms(torch, lambda: ks.mttkrp_slab_plain(
            idxp, valsp, lrowsp, rb_of, in_f, **kw), 5)
        lib, krp_bytes = library_mttkrp(torch, np, t.indices, t.shape, d,
                                        t.values, in_f)
        library_ms = cuda_ms(torch, lib, 5)
        per_mode.append({"mode": d, "ms": ms, **split, "host_ms": host, **facts,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "library_krp_bytes": krp_bytes, **bound})

        v = resid[perm]
        valued = ks.mttkrp_slab_valued(idxp, v, scatter, lrowsp, rb_of, in_f,
                                       chunks=chunks, rank_block=rb, **kw)
        vals_v = ks.scatter_slab_values(v, scatter, slots)
        plain = ks.mttkrp_slab_plain(idxp, vals_v, lrowsp, rb_of, in_f, **kw)
        exact = mttkrp_f64(torch, idxp, vals_v, lrowsp, rb_of, in_f, **kw)
        mag = ks.mttkrp_slab_plain(idxp, vals_v.abs(), lrowsp, rb_of,
                                   [f.abs() for f in in_f], **kw)
        torch.cuda.synchronize()
        err, tol = float((valued - exact).abs().max()), 1e-5 * float(mag.max())
        plain_err = float((plain - exact).abs().max())
        check(err <= tol, f"valued mode {d}: err {err} > tol {tol}")
        del valued, plain, exact, mag, vals_v
        scatter_ms = cuda_ms(torch, lambda: ks.scatter_slab_values(v, scatter, slots),
                             TIMED_LAUNCHES)
        valued_fn = functools.partial(ks.mttkrp_slab_valued, idxp, v, scatter, lrowsp,
                                      rb_of, in_f, chunks=chunks, rank_block=rb, **kw)
        valued_ms = cuda_ms(torch, valued_fn, TIMED_LAUNCHES)
        valued_split = pass_times(torch, valued_fn, TIMED_LAUNCHES)
        valued_plain_ms = cuda_ms(torch, lambda: ks.mttkrp_slab_plain(
            idxp, ks.scatter_slab_values(v, scatter, slots), lrowsp, rb_of, in_f,
            **kw), 5)
        vlib, _ = library_mttkrp(torch, np, t.indices, t.shape, d, resid, in_f)
        valued_modes.append({
            "mode": d, "ms": valued_ms, "scatter_ms": scatter_ms,
            "kernel_ms": valued_ms - scatter_ms, **valued_split,
            "host_ms": host_ms(torch, clock, valued_fn, TIMED_LAUNCHES),
            "staged_inputs": facts["staged_inputs"], "plain_ms": valued_plain_ms,
            "library_ms": cuda_ms(torch, vlib, 5), "max_abs_err": err, "tol": tol,
            "plain_f32_err": plain_err,
            # the values (nnz float32) and their slots (nnz int64) replace
            # the packed values among the inputs
            **slab_bound(slots, len(others), chunk_ints, factor_rows, out_rows,
                         value_bytes=t.nnz * 12)})
        del lib, vlib
        torch.cuda.empty_cache()

    # Sweep split on the main path's data: MTTKRP, fit, and the rest; the
    # per-sweep update tails of cp and nncp (HALS) on the same MTTKRPs.
    one = als_device._build_one_mttkrp("slab", t.nmodes, shapes, meta)
    fit_fn = als_device._build_sparse_fit(t.nmodes, RANK)
    one_sweep = als_device._build_sweep_block("slab", t.nmodes, RANK, shapes,
                                              meta, "cho", 1)
    st = state_from_reference(*als_device.init_state_host(shapes, RANK, 0), device=dev)
    mttkrp_ms = cuda_ms(torch, lambda: [one(d, mode_data[d], st[0])
                                        for d in range(t.nmodes)], 5)
    fit_ms = cuda_ms(torch, lambda: fit_fn(st[0], st[1], st[2], fit_data), 5)
    sweep_ms = cuda_ms(torch, lambda: one_sweep(st, mode_data, fit_data), 5)
    ctx = als_device.make_sweep_context("slab", t.nmodes, RANK, shapes, meta, "cho")
    Ms = [one(d, mode_data[d], st[0]) for d in range(t.nmodes)]

    def tail(update):
        return lambda: [update(ctx, d, Ms[d], list(st[0]), list(st[1]), st[2], False)
                        for d in range(t.nmodes)]

    hals_ms = cuda_ms(torch, tail(nncp.update), 5)
    cp_tail_ms = cuda_ms(torch, tail(als_device.cp_update), 5)
    nn_sweep = als_device._build_sweep_block("slab", t.nmodes, RANK, shapes, meta,
                                             "cho", 1, "nncp")
    nn_sweep_ms = cuda_ms(torch, lambda: nn_sweep(st, mode_data, fit_data), 5)
    mk_sweep = als_device._build_sweep_block("slab", t.nmodes, RANK, shapes, smeta,
                                             "cho", 1, "masked")
    mk_sweep_ms = cuda_ms(torch, lambda: mk_sweep(st, smd, mfd), 5)
    two_sweeps = als_device._build_sweep_block("slab", t.nmodes, RANK, shapes,
                                               meta, "cho", 2)
    two_sweeps(st, mode_data, fit_data)
    profile = device_idle(torch, lambda: two_sweeps(st, mode_data, fit_data), clock)
    del Ms

    # The batched entry per uber mode at B = 8, beside 8 torch.sparse.mm.
    batched_times = []
    for d in range(len(UBER_SHAPE)):
        idxp, valsp, lrowsp, rb_of, chunks, _ = prep_cp.mode_data_all[d]
        nrb, br, tile, rblk = prep_cp.slab_meta[d]
        others = [w for w in range(len(UBER_SHAPE)) if w != d]
        in_f = [bfac[w] for w in others]
        kw = dict(num_row_blocks=nrb, block_rows=br, tile=tile)
        slots = int(idxp.shape[-1])
        batched_fn = functools.partial(ks.mttkrp_slab_batched, idxp, valsp, lrowsp,
                                       rb_of, in_f, chunks=chunks, rank_block=rblk, **kw)
        ms = cuda_ms(torch, batched_fn, TIMED_LAUNCHES)
        batched_split = pass_times(torch, batched_fn, TIMED_LAUNCHES)
        plain_ms = cuda_ms(torch, lambda: ks.mttkrp_slab_batched_plain(
            idxp, valsp, lrowsp, rb_of, in_f, **kw), 3)
        library_ms, krp_bytes = 0.0, 0
        for b, x in enumerate(lanes):
            lib, krp_bytes = library_mttkrp(torch, np, x.indices, UBER_SHAPE, d,
                                            x.values, [f[b] for f in in_f])
            library_ms += cuda_ms(torch, lib, 3)
            del lib
            torch.cuda.empty_cache()
        batched_times.append({
            "mode": d, "lanes": LANES, "ms": ms, **batched_split,
            "host_ms": host_ms(torch, clock, batched_fn, TIMED_LAUNCHES),
            **launch_facts(ks, build.load_library(), dev, RANK, rblk, br, others,
                           UBER_SHAPE),
            "plain_ms": plain_ms,
            "library_ms": library_ms, "library_krp_bytes_per_lane": krp_bytes,
            **slab_bound(LANES * slots, len(others),
                         chunks.numel(),
                         LANES * sum(UBER_SHAPE[w] for w in others),
                         LANES * nrb * br)})

    # Sweep time at B = 8 and B = 1 per method, and two profiled B = 8 sweeps.
    sweeps = {}
    for method in METHODS:
        prep1 = eng.prepare_batch(
            lanes[:1], n_iters=10, seeds=[0], nnz_cap=cap, method=method,
            **({"weights": lane_w[:1]} if method == "masked" else {}))
        row = {}
        for B, prep in ((LANES, preps[method]), (1, prep1)):
            fn = eng_block(eng, prep, 1)
            ms = cuda_ms(torch, lambda: fn(prep.carry, prep.mode_data_all,
                                           prep.fit_data, prep.tol_dev,
                                           prep.max_iters_dev), 5)
            row[f"B{B}_sweep_ms"] = ms
            row[f"B{B}_decompositions_per_s"] = B * 1e3 / (10 * ms)
        sweeps[method] = row
        del prep1
    two_b = eng_block(eng, prep_cp, 2)
    args = (prep_cp.carry, prep_cp.mode_data_all, prep_cp.fit_data, prep_cp.tol_dev,
            prep_cp.max_iters_dev)
    two_b(*args)
    batched_profile = device_idle(torch, lambda: two_b(*args), clock)

    emit({"phase": "times", "nvidia_smi": smi, "modes": per_mode,
          "sweep_ms": sweep_ms, "mttkrp_ms": mttkrp_ms, "fit_ms": fit_ms,
          "solve_and_other_ms": sweep_ms - mttkrp_ms - fit_ms,
          "cp_tail_ms": cp_tail_ms, "hals_tail_ms": hals_ms,
          "nncp_sweep_ms": nn_sweep_ms, "masked_sweep_ms": mk_sweep_ms,
          "profile": {"sweeps": 2, **profile},
          "valued_modes": valued_modes, "batched_modes": batched_times,
          "batched_sweeps": sweeps,
          "batched_profile": {"sweeps": 2, "lanes": LANES, "method": "cp",
                              **batched_profile}})

    # -- plan: the paper's scheme choice and the planning tools ----------------
    plan_out = plan_phase(torch, np, clock, ks, dev, t, lanes[0])
    emit(plan_out)

    def kernel_entry(name, modes, launches, err, phases):
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/mttkrp_slab.cu",
            "replaces": "src/repro/kernels/mttkrp_pallas.py:166",
            "launches": launches, "phases": phases, "max_abs_err": err,
            "ms": sum(m["ms"] for m in modes),
            "plain_ms": sum(m["plain_ms"] for m in modes),
            "bound_ms": sum(m["bound_ms"] for m in modes),
            "bound_by": "bytes" if all(m["bound_by"] == "bytes" for m in modes)
            else "operations",
            "library_ms": sum(m["library_ms"] for m in modes),
        }

    # Launches per phase that ran the entry, each counted from 0 in its phase.
    service = new_phases["service"]
    emit({"kernels": [
        kernel_entry("mttkrp_slab", per_mode, launches,
                     max(m["max_abs_err"] for m in modes),
                     {"main_path": launches, "methods": nn_launches["mttkrp_slab"],
                      "stream": new_phases["stream"]["launches"],
                      "plan": plan_out["launches"]}),
        kernel_entry("mttkrp_slab_valued", valued_modes,
                     mk_launches["mttkrp_slab_valued"],
                     max(m["max_abs_err"] for m in valued_modes),
                     {"methods": mk_launches["mttkrp_slab_valued"],
                      "stream_masked": new_phases["stream_masked"]["launches"][
                          "mttkrp_slab_valued"]}),
        kernel_entry("mttkrp_slab_batched", batched_times, batched_launches,
                     max(m["max_abs_err"] for m in batched_modes),
                     {"batched": batched_launches,
                      "service": service["sync"]["launches"]
                      + service["double_buffer"]["launches"]
                      + service["runner_stream"]["launches"]}),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
