#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root; needs one card)

Builds the port's CUDA kernel from ``src/repro_torch/csrc`` into ``build/``,
holds it against its plain PyTorch version at the main path's shapes, runs
sparse CPD-ALS on the chicago-shaped FROSTT stand-in (6186 x 24 x 77 x 32,
5,330,673 nonzeros, rank 16) through the kernel, checks the result, and
times the kernel beside its byte bound, its plain version and one PyTorch
library call.  Prints one JSON line per phase, then the ``{"kernels": ...}``
line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
then exits non-zero and prints no ``ok`` line.  It imports nothing of JAX.
"""
from __future__ import annotations

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
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln] if log.exists() else []
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
        idxp, valsp, lrowsp, rb_of, chunks, _ = plan.device_packed(d)
        p = plan.packed(d)
        in_f = [facs[w] for w in plan.layouts[d].input_modes()]
        kw = dict(num_row_blocks=p.num_row_blocks, block_rows=p.block_rows,
                  tile=p.tile)
        k = ks.mttkrp_slab(idxp, valsp, lrowsp, rb_of, in_f, chunks=chunks,
                           rank_block=rank_block, **kw)
        plain = ks.mttkrp_slab_plain(idxp, valsp, lrowsp, rb_of, in_f, **kw)
        # Tolerance: float32 sums of up to ~2.2e5 terms taken in two orders
        # differ by a small multiple of eps times the absolute sum (about
        # 1.5e-7 of it measured on the H100); hold them to 1e-5 of it.
        mag = ks.mttkrp_slab_plain(idxp, valsp.abs(), lrowsp, rb_of,
                                   [f.abs() for f in in_f], **kw)
        tol = 1e-5 * float(mag.max())
        torch.cuda.synchronize()
        err = float((k - plain).abs().max())
        check(bool(torch.isfinite(k).all()), f"mode {d}: non-finite kernel output")
        return err, tol

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
    ks.LAUNCHES = 0
    res = cpd_als(t, RANK, plan=plan, backend="slab", n_iters=10,
                  check_every=5, device="cuda")
    launches = ks.LAUNCHES
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

    # -- times -----------------------------------------------------------------
    per_mode = []
    for d in range(t.nmodes):
        idxp, valsp, lrowsp, rb_of, chunks, _ = plan.device_packed(d)
        p = plan.packed(d)
        lay = plan.layouts[d]
        others = lay.input_modes()
        in_f = [f16[w] for w in others]
        kw = dict(num_row_blocks=p.num_row_blocks, block_rows=p.block_rows,
                  tile=p.tile)
        rb = plan.mode_plan(d, RANK).rank_block
        ms = cuda_ms(torch, lambda: ks.mttkrp_slab(
            idxp, valsp, lrowsp, rb_of, in_f, chunks=chunks, rank_block=rb, **kw),
            TIMED_LAUNCHES)
        plain_ms = cuda_ms(torch, lambda: ks.mttkrp_slab_plain(
            idxp, valsp, lrowsp, rb_of, in_f, **kw), 5)
        # Library yardstick: CSR matricization times the dense Khatri-Rao.
        idx = torch.as_tensor(t.indices, device=dev).long()
        cols = torch.zeros(t.nnz, dtype=torch.long, device=dev)
        for w in others:
            cols = cols * t.shape[w] + idx[:, w]
        ncols = int(np.prod([t.shape[w] for w in others]))
        csr = torch.sparse_coo_tensor(
            torch.stack([idx[:, d], cols]),
            torch.as_tensor(t.values, device=dev), (t.shape[d], ncols),
            check_invariants=False).coalesce().to_sparse_csr()
        krp = in_f[0]
        for f in in_f[1:]:
            krp = (krp[:, None, :] * f[None, :, :]).reshape(-1, RANK)
        library_ms = cuda_ms(torch, lambda: torch.sparse.mm(csr, krp), 5)
        del csr, krp, idx, cols
        slots = p.num_slabs * p.tile
        nbytes = (slots * (len(others) + 2) * 4
                  + sum(int(c.numel()) * 4 for c in (chunks.chunk_slab, chunks.rb_chunk_ptr))
                  + sum(t.shape[w] * RANK * 4 for w in others)
                  + p.num_row_blocks * p.block_rows * RANK * 4)
        ops = slots * RANK * (len(others) + 1)
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = ops / F32_OPS_PER_S * 1e3
        per_mode.append({
            "mode": d, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "bytes": nbytes, "ops": ops})
    torch.cuda.empty_cache()

    # Sweep split on the main path's data: MTTKRP, fit, and the rest.
    one = als_device._build_one_mttkrp("slab", t.nmodes, shapes, meta)
    fit_fn = als_device._build_sparse_fit(t.nmodes, RANK)
    one_sweep = als_device._build_sweep_block("slab", t.nmodes, RANK, shapes,
                                              meta, "cho", 1)
    st = state_from_reference(*als_device.init_state_host(shapes, RANK, 0), device=dev)
    mttkrp_ms = cuda_ms(torch, lambda: [one(d, mode_data[d], st[0])
                                        for d in range(t.nmodes)], 5)
    fit_ms = cuda_ms(torch, lambda: fit_fn(st[0], st[1], st[2], fit_data), 5)
    sweep_ms = cuda_ms(torch, lambda: one_sweep(st, mode_data, fit_data), 5)

    from torch.profiler import ProfilerActivity, profile
    two_sweeps = als_device._build_sweep_block("slab", t.nmodes, RANK, shapes,
                                               meta, "cho", 2)
    two_sweeps(st, mode_data, fit_data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = clock.now()
        two_sweeps(st, mode_data, fit_data)
        torch.cuda.synchronize()
        wall_ms = (clock.now() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    emit({"phase": "times", "nvidia_smi": smi, "modes": per_mode,
          "sweep_ms": sweep_ms, "mttkrp_ms": mttkrp_ms, "fit_ms": fit_ms,
          "solve_and_other_ms": sweep_ms - mttkrp_ms - fit_ms,
          "profile": {"sweeps": 2, "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms if kernels else None,
                      "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else None,
                      "top": [{"name": e.key[:60], "count": e.count,
                               "ms": dev_us(e) / 1e3} for e in top]}})

    emit({"kernels": [{
        "name": "mttkrp_slab", "route": "cuda",
        "source": "src/repro_torch/csrc/mttkrp_slab.cu",
        "replaces": "src/repro/kernels/mttkrp_pallas.py:166",
        "launches": launches,
        "max_abs_err": max(m["max_abs_err"] for m in modes),
        "ms": sum(m["ms"] for m in per_mode),
        "plain_ms": sum(m["plain_ms"] for m in per_mode),
        "bound_ms": sum(m["bound_ms"] for m in per_mode),
        "bound_by": "bytes" if all(m["bound_by"] == "bytes" for m in per_mode)
        else "operations",
        "library_ms": sum(m["library_ms"] for m in per_mode),
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
