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

Then

  embed     -- the CPD-factorized embedding of qwen1.5-4b at full width
               (vocab 151,936 padded to 152,064 = 390 x 390, d_model
               2560, CP rank 256) on 8 x 4096 Zipf-drawn tokens: the
               gradient of A and B as the slab kernel on modes 0 and 1 of
               the batch tensor (B1f), against its plain version, against
               autograd and through three AdamW steps; the lookup against
               the dense table;
  lm        -- the LM serving path: qwen1.5-4b at full width (40 layers,
               d_model 2560, vocab 152,064) with random weights from a
               seed, through ``launch.serve.generate`` on batch 8, prompt
               128, 64 tokens: float32 and bfloat16 decode against
               ``forward``, the int8 cache against the native one, the
               CPD-factorized embedding at rank 256, no host read in a
               decode loop; the bf16 run's times beside its byte bound,
               and the idle share of decode steps;
  lm_moe, lm_ssm, lm_hybrid, lm_hybrid_long, lm_encdec -- the other LM
               families at full width through the same launcher run:
               granite-moe-1b-a400m (24 layers, 32 experts top-8),
               mamba2-780m (48 SSD layers), hymba-1.5b (32 layers, 128
               meta tokens, window 1024; again at batch 2, prompt 1024,
               16 tokens, past its window, at 8 layers) and
               whisper-large-v3 (32 + 32 layers, 1500 encoder frames):
               float64 decode against
               ``forward`` (the decode path's exactness), float32 decode
               against the float64 model, bf16 decode against bf16
               ``forward`` and bf16 against float64 at each family's
               limits, hymba's int8 cache against its bf16 decode, for
               MoE the router choices bf16 changes; the bf16 times beside
               the byte bound of a decode step, the idle share of decode
               steps and the peak memory;
  train     -- LM training through ``launch.train``'s code path
               (``make_trainer``, ``Trainer``, the token pipeline):
               internvl2-1b at full width (24 layers, d_model 896, vocab
               151,808; bf16, remat, batch 8 x 256 tokens), 6 steps with
               a checkpoint at step 3 and a restart from it that must
               repeat steps 4-6 bitwise, the first loss against
               ``model.loss`` outside the step, the float32 gradient
               against float64; granite-moe-1b-a400m's capacity dispatch
               for 3 steps, its float32 gradient against float64; each
               step's ms, tokens/s, host reads and peak memory beside the
               step's FLOP and byte bounds, one step's idle share; then
               ``examples/factorized_embedding_torch.py`` on the card;
  dryrun    -- the dry run (``repro_torch.launch.dryrun``) held to the
               card: the H100 table's SM count and memory; the train
               phase's step (internvl2-1b, 8 x 256) and the lm phase's
               bf16 decode step (qwen1.5-4b, batch 8, 192 positions)
               counted by ``OpCounter`` on ``meta`` and on the card, FLOPs
               and bytes equal, the card's peak memory against the counted
               peak, the counted bound beside the step's ms;
  dist, pod -- the distributed engine and the batched engine's pod path
               at kappa = 1 (NCCL) and kappa = 2 (gloo, two ranks on the
               one card), the pod's requests also through
               ``DecompositionService(mesh=)``, a zero iteration budget,
               and at kappa = 2 the optimizer's ``cross_pod_mean``.

Prints one JSON line per phase (each also appended, whole, to
``build/chip_smoke.jsonl``, which a run starts afresh), then the
``{"kernels": ...}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
then exits non-zero and prints no ``ok`` line.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
JSONL = ROOT / "build" / "chip_smoke.jsonl"
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
# The dist and pod phases: 10 sweeps in windows of 5; the pod decomposes
# the first 6 requests of the uber bucket on a batch quantum of 4 (two
# padding lanes); the kappa = 2 ranks are spawned with this time limit.
DIST_SWEEPS, DIST_CHECK = 10, 5
POD_REQUESTS, POD_QUANTUM = 6, 4
RANK_TIMEOUT_S = 600
# The pod phase also serves its requests through DecompositionService(mesh=)
# for these methods, and runs a zero iteration budget on 2 small requests.
SERVICE_METHODS = ("cp", "masked")
ZERO_BUDGET_NNZ = 4_096
# The embed phase: the CPD-factorized embedding of qwen1.5-4b at full
# width (vocab 151,936, padded to a multiple of 256; d_model 2560), CP
# rank 256, on one batch of 8 x 4096 tokens drawn from a Zipf law.
EMBED_VOCAB, EMBED_D, EMBED_RANK = 151_936, 2560, 256
EMBED_BATCH = (8, 4096)
EMBED_ZIPF = 1.1
EMBED_KAPPA = 8               # grad_factors_mttkrp's default partitions
EMBED_ADAMW_STEPS = 3
# The lm phase: qwen1.5-4b at full width through the serving launcher's
# ``generate``, the launcher's documented run (batch 8, prompt 128, 64
# tokens, a float32 cache); the decode steps held against ``forward``, and
# the decode steps the profiler watches for the idle share.
LM_ARCH = "qwen1.5-4b"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 128, 64
LM_CPD_RANK = 256
LM_CHECK_STEPS = (1, 21, 42, 63)
LM_IDLE_STEPS = 8
LM_INT8_ARGMAX = 0.90         # least share of argmax kept by the int8 cache
# The family phases: the other LM families at full width through the same
# launcher run (name, arch, batch, prompt, tokens); hymba a second time
# with a prompt past its window of 1024 (meta 128 + 1024 + 16 = 1168), so
# its sliding-window rings wrap and the SSD scan runs several chunks.
FAMILY_RUNS = (
    ("lm_moe", "granite-moe-1b-a400m", LM_BATCH, LM_PROMPT, LM_GEN),
    ("lm_ssm", "mamba2-780m", LM_BATCH, LM_PROMPT, LM_GEN),
    ("lm_hybrid", "hymba-1.5b", LM_BATCH, LM_PROMPT, LM_GEN),
    ("lm_hybrid_long", "hymba-1.5b", 2, 1024, 16),
    ("lm_encdec", "whisper-large-v3", LM_BATCH, LM_PROMPT, LM_GEN),
)
# The depth cut of a family run, for the script's time: hymba's second run
# keeps its width, window and prompt past the window, and its 8 layers
# keep the global / sliding-window / global / sliding-window / global
# segments of the 32 (``lm_hybrid`` runs all 32).
FAMILY_DEPTH = {"lm_hybrid_long": {"num_layers": 8, "global_attn_layers": (0, 3, 7)}}
# Each family phase's bf16 gates, set from its readings on the H100
# (PERF.md §6, PR 23; the runs are seeded and gave the same errors every
# time): bf16 decode against bf16 ``forward`` (the largest ``rel`` of the
# checked steps, "bf16") and the share of (sequence, step) pairs whose
# argmax agrees ("bf16_argmax"); bf16 ``forward`` against float64
# ``forward`` (the median ``rel`` of its rows, "f64_median", and the
# argmax share, "f64_argmax"); hymba's int8 cache against the bf16 decode
# ("int8", "int8_argmax").  ``rel`` of zeros is 1 and of a random vector of the
# same norm above 1, and the argmax of either agrees on about no pair, so
# each gate fails them.  Whisper keeps the ``lm`` phase's 5e-2: its bf16
# lies within 2e-2 of float64.  The random MoE, SSM and hybrid models
# amplify bf16 rounding (ROADMAP C-ref8), so theirs are wider.
FAMILY_LIMITS = {
    "lm_moe": {"bf16": 0.75, "bf16_argmax": 0.40, "f64_median": 0.70, "f64_argmax": 0.15},
    "lm_ssm": {"bf16": 0.65, "bf16_argmax": 0.30, "f64_median": 0.60, "f64_argmax": 0.15},
    "lm_hybrid": {"bf16": 0.40, "bf16_argmax": 0.50, "f64_median": 0.35, "f64_argmax": 0.40,
                  "int8": 0.55, "int8_argmax": 0.50},
    "lm_hybrid_long": {"bf16": 0.40, "bf16_argmax": 0.50, "f64_median": 0.35,
                       "f64_argmax": 0.35, "int8": 0.40, "int8_argmax": 0.50},
    "lm_encdec": {"bf16": 5e-2, "bf16_argmax": 0.85, "f64_median": 3e-2, "f64_argmax": 0.75},
}

# The train phase: the training launcher's default run (internvl2-1b with
# its config edits, batch 8 x 256 tokens, bf16, remat "full", the schedule
# of its 200 default steps) for TRAIN_STEPS steps with a checkpoint every
# TRAIN_CKPT_EVERY, then a restart from that checkpoint; granite-moe-1b's
# capacity dispatch for TRAIN_MOE_STEPS steps; each family's float32
# gradient against float64 at its TRAIN_GRAD_LIMITS (global relative norm).
TRAIN_ARCH, TRAIN_MOE_ARCH = "internvl2-1b", "granite-moe-1b-a400m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_SCHEDULE_STEPS = 8, 256, 200
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_MOE_STEPS = 6, 3, 3
TRAIN_GRAD_LIMITS = {TRAIN_ARCH: 1e-4, TRAIN_MOE_ARCH: 1e-3}

# The dryrun phase: the card's peak memory over the counted train step
# against the dry run's peak live bytes, within these ratios.
DRYRUN_MEMORY_RATIO = (0.75, 1.33)


def emit(obj) -> None:
    """Print one JSON line, and append it to ``build/chip_smoke.jsonl``
    (git ignores it), whole, where the end of the output would cut it."""
    line = json.dumps(obj)
    print(line, flush=True)
    JSONL.parent.mkdir(exist_ok=True)
    with open(JSONL, "a") as f:
        f.write(line + "\n")


def hw_peak(key: str) -> float:
    """A data-sheet peak of the H100 SXM at 700 W (``hbm_bw``,
    ``peak_flops_bf16``, ...) from the port's one table,
    ``repro_torch.launch.mesh.HW``."""
    from repro_torch.launch.mesh import HW

    return HW[key]


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


@functools.lru_cache(maxsize=None)
def uber_full():
    """The full uber stand-in, generated once for the stream and plan
    phases (neither changes it)."""
    from repro_torch.core.coo import frostt_like

    return frostt_like("uber", scale=1.0)


def reset_launches(ks) -> None:
    for entry in ks.LAUNCHES:
        ks.LAUNCHES[entry] = 0
    for entry in getattr(ks, "CAPTURES", ()):
        ks.CAPTURES[entry] = 0


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


def replay_gaps(np, rep, eager) -> dict:
    """A replayed call's fits and factors against an eager call's from the
    same start: the largest gaps relative to the fit and to each factor's
    largest entry, and whether fits, factors and weights are bitwise."""
    fits, want = np.array(rep.fits), np.array(eager.fits)
    return {"fit_rel": float(np.max(np.abs(fits - want) / np.abs(want))),
            "factor_rel": max(float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                              for a, b in zip(rep.factors, eager.factors)),
            "bitwise": bool(np.array_equal(fits, want)
                            and np.array_equal(rep.weights, eager.weights)
                            and all(np.array_equal(a, b) for a, b
                                    in zip(rep.factors, eager.factors)))}


def check_replay(np, ks, name, rep, eager, seg, launches) -> dict:
    """Gate a second call on a held plan: every sweep replayed from the
    plan's graphs, 40 counted kernel launches and no capture, the eager
    call's host reads, fits within 1e-6 and factors within 1e-5 of the
    eager call's (relative), fits within 1e-5 of the segment backend's."""
    out = {"launches": launches, "captures": ks.CAPTURES["mttkrp_slab"],
           "graph_sweeps": rep.graph_sweeps, "host_syncs": rep.host_syncs,
           **replay_gaps(np, rep, eager),
           "segment_fit_gap": fit_gap(np, rep.fits, seg.fits)}
    check(rep.graph_sweeps == rep.iters == 10,
          f"{name} replay: graph_sweeps {rep.graph_sweeps} of {rep.iters}")
    check(launches == 40 and out["captures"] == 0,
          f"{name} replay counted {launches} launches, {out['captures']} captures")
    check(rep.host_syncs == eager.host_syncs,
          f"{name} replay host_syncs {rep.host_syncs} != {eager.host_syncs}")
    check(out["fit_rel"] <= 1e-6 and out["factor_rel"] <= 1e-5,
          f"{name} replay differs from the eager call: {out}")
    check(out["segment_fit_gap"] <= 1e-5,
          f"{name} replay fits differ from segment by {out['segment_fit_gap']}")
    return out


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


def slab_bound(slots, W, chunk_ints, factor_rows, out_rows, value_bytes=None,
               rank=RANK):
    """The least time of one slab MTTKRP: bytes (each input read once, each
    output written once) over the card's memory rate, or its float32
    operations over the float32 rate, whichever is larger.  The inputs are
    the packed indices and local rows, the values (``value_bytes``;
    default the packed float32 values), the chunk tables, the factors."""
    if value_bytes is None:
        value_bytes = slots * 4
    nbytes = (slots * (W + 1) * 4 + value_bytes + chunk_ints * 4
              + factor_rows * rank * 4 + out_rows * rank * 4)
    ops = slots * rank * (W + 1)
    bound_bytes = nbytes / hw_peak("hbm_bw") * 1e3
    bound_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "bytes": nbytes, "ops": ops}


def dev_us(e) -> float:
    """Device time of one ``key_averages()`` entry, in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


def device_idle(torch, fn, clock):
    """Wall time, device busy time, idle share, the number of device
    activities (kernels and copies) and the top kernels of one ``fn()``
    under ``torch.profiler`` (``fn`` has run once before)."""
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
            "kernels": sum(e.count for e in kernels),
            "top": [{"name": e.key[:60], "count": e.count, "ms": dev_us(e) / 1e3}
                    for e in top]}


def pass_times(torch, fn, calls: int):
    """Device time per call of the slab kernel's pass one
    (``chunk_tiles_kernel``) and pass two (both ``sum_ranges_kernel``
    launches), from ``torch.profiler``'s ``key_averages()`` over ``calls``
    calls of ``fn`` (made after the CUDA-event timing of the same calls).
    A window in which the profiler recorded neither pass is profiled
    again, at most twice: on the H100 one whole run in four recorded
    none in one window, the kernel's results and the CUDA-event times of
    the same calls being in order."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
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
        if split["pass_one_ms"] > 0 or split["pass_two_ms"] > 0:
            break
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
    from repro_torch.core.coo import SparseTensor
    from repro_torch.methods import StreamingCP

    t0 = clock.now()
    full = uber_full()
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


def abs_mttkrp_max(ks, plan, F, d) -> float:
    """Largest entry of mode ``d``'s MTTKRP of ``|vals|`` and ``|F|`` (the
    slab kernel's plain version on the plan's packing): the scale that
    every 1e-5 gate of this script is taken of."""
    idxp, valsp, lrowsp, rb_of, _, _ = plan.device_packed(d)
    p = plan.packed(d)
    mag = ks.mttkrp_slab_plain(idxp, valsp.abs(), lrowsp, rb_of,
                               [F[v].abs() for v in plan.layouts[d].input_modes()],
                               num_row_blocks=p.num_row_blocks, block_rows=p.block_rows,
                               tile=p.tile)
    return float(mag.max())


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
    from repro_torch.core.coo import SparseTensor
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
    uber = uber_full()
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
            imbalance_reps=1, device=dev)
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


def zipf_tokens(np, vocab: int, shape, exponent: float, seed: int):
    """Token ids from a Zipf law over the vocabulary: id k has probability
    proportional to (k + 1)^-exponent, so low ids are the frequent ones,
    as a BPE vocabulary numbers its merges by frequency."""
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -exponent
    rng = np.random.default_rng(seed)
    return rng.choice(vocab, size=shape, p=p / p.sum()).astype(np.int32)


def rel_err(a, b) -> float:
    """Largest entry of |a - b| over the largest entry of |b|."""
    return float((a - b).abs().max() / b.abs().max())


def embed_phase(torch, np, clock, ks, dev):
    """The CPD-factorized embedding of qwen1.5-4b at full width: one token
    batch's gradient of A and B through B1f (``grad_factors_mttkrp``, the
    slab kernel on modes 0 and 1 of the batch tensor), counted from 0,
    then the lookup against the dense table, B1f against its plain
    version and against autograd, its times, and AdamW steps on B1f's
    gradients against the same steps on autograd's."""
    from repro_torch import optim
    from repro_torch.core.mttkrp import make_plan, mttkrp
    from repro_torch.models import factorized_embed as fe
    from repro_torch.models.common import build_params, pad_vocab

    V = pad_vocab(EMBED_VOCAB)
    t0 = clock.now()
    p = build_params(fe.cpd_embed_specs(V, EMBED_D, EMBED_RANK),
                     torch.Generator(device=dev).manual_seed(0), torch.float32, device=dev)
    toks = torch.as_tensor(zipf_tokens(np, EMBED_VOCAB, EMBED_BATCH, EMBED_ZIPF, seed=0),
                           device=dev)
    dY = torch.randn((*EMBED_BATCH, EMBED_D), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    gen_s = clock.now() - t0

    # The user path, its launches counted from 0.
    reset_launches(ks)
    dA, dB = fe.grad_factors_mttkrp(p, toks, dY, V)
    torch.cuda.synchronize()
    launches = dict(ks.LAUNCHES)
    check(launches["mttkrp_slab"] == 2
          and launches["mttkrp_slab_valued"] == launches["mttkrp_slab_batched"] == 0,
          f"embed: the gradient launched {launches}, not 2 mttkrp_slab")
    check(bool(torch.isfinite(dA).all() and torch.isfinite(dB).all()),
          "embed: non-finite gradient")

    look = fe.cpd_embed_lookup(p, toks, V)
    table = fe.dense_table(p, V)
    table_bytes = table.numel() * table.element_size()
    lookup_err = rel_err(look, table[toks.long()])
    check(lookup_err <= 1e-5, f"embed: lookup differs from the dense table by {lookup_err}")
    del table, look

    # The same problem planned apart, to time its host half and hold the
    # kernel against its plain version and against autograd.
    t0 = clock.now()
    tensor = fe.batch_as_sparse_tensor(toks, V)
    batch_ms = (clock.now() - t0) * 1e3
    t0 = clock.now()
    plan = make_plan(tensor, EMBED_KAPPA, device=dev)
    make_plan_ms = (clock.now() - t0) * 1e3
    t0 = clock.now()
    for d in (0, 1):
        plan.device_packed(d)
    torch.cuda.synchronize()
    pack_ms = (clock.now() - t0) * 1e3
    factors = [p["A"], p["B"], dY.reshape(-1, EMBED_D) @ p["C"]]
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    look = fe.cpd_embed_lookup(leaves, toks, V)
    auto = torch.autograd.grad(look, (leaves["A"], leaves["B"]), dY, retain_graph=True)
    library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        look, (leaves["A"], leaves["B"]), dY, retain_graph=True), 5)
    modes = []
    for d, got in ((0, dA), (1, dB)):
        pk = plan.packed(d)
        rb = plan.mode_plan(d, EMBED_RANK).rank_block
        others = plan.layouts[d].input_modes()
        in_f = [factors[w] for w in others]
        idxp, valsp, lrowsp, rb_of, chunks, _ = plan.device_packed(d)
        kw = dict(num_row_blocks=pk.num_row_blocks, block_rows=pk.block_rows, tile=pk.tile)
        err, tol = kernel_vs_plain_err(torch, ks, plan.device_packed(d), in_f,
                                       (pk.num_row_blocks, pk.block_rows, pk.tile, rb),
                                       f"embed mode {d}")
        check(err <= tol, f"embed mode {d}: kernel vs plain {err} > {tol}")
        same = bool(torch.equal(mttkrp(plan, factors, d), got))
        check(same, f"embed mode {d}: the gradient differs from the kernel on its plan")
        scale = abs_mttkrp_max(ks, plan, factors, d)
        auto_err = float((got - auto[d]).abs().max())
        check(auto_err <= 1e-4 * scale, f"embed mode {d}: B1f vs autograd {auto_err} > "
                                        f"{1e-4 * scale}")
        baked = functools.partial(ks.mttkrp_slab, idxp, valsp, lrowsp, rb_of, in_f,
                                  chunks=chunks, rank_block=rb, **kw)
        rows = np.bincount(tensor.indices[:, d], minlength=tensor.shape[d])
        # The plan's rank block against narrower ones: each rank block is
        # another set of pass-one blocks over the same chunks.
        by_rank_block = {rbk: cuda_ms(torch, functools.partial(baked, rank_block=rbk),
                                      TIMED_LAUNCHES) for rbk in (32, 64, 128, 256)}
        modes.append({
            "mode": d, "rows": int(tensor.shape[d]), "rows_used": int((rows > 0).sum()),
            "largest_row_nnz": int(rows.max()), "slabs": pk.num_slabs,
            "chunks": chunks.num_chunks, "rank_block": rb, "ms_by_rank_block": by_rank_block,
            "max_abs_err": err, "tol": tol,
            "autograd_err": auto_err, "autograd_tol": 1e-4 * scale,
            "ms": cuda_ms(torch, baked, TIMED_LAUNCHES),
            **pass_times(torch, baked, TIMED_LAUNCHES),
            "host_ms": host_ms(torch, clock, baked, TIMED_LAUNCHES),
            "plain_ms": cuda_ms(torch, lambda: ks.mttkrp_slab_plain(
                idxp, valsp, lrowsp, rb_of, in_f, **kw), 5),
            **slab_bound(pk.num_slabs * pk.tile, len(others), chunks.numel(),
                         sum(tensor.shape[w] for w in others),
                         pk.num_row_blocks * pk.block_rows, rank=EMBED_RANK)})
    del look, auto, leaves
    step = device_idle(torch, lambda: fe.grad_factors_mttkrp(p, toks, dY, V), clock)

    # AdamW on A, B and C: B1f's gradients of A and B against autograd's
    # (C's gradient is autograd's in both runs).
    cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")

    def adamw_steps(b1f: bool):
        params = {k: v.clone() for k, v in p.items()}
        state = optim.init_state(params)
        for _ in range(EMBED_ADAMW_STEPS):
            x = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            grads = dict(zip("ABC", torch.autograd.grad(
                fe.cpd_embed_lookup(x, toks, V), (x["A"], x["B"], x["C"]), dY)))
            if b1f:
                grads["A"], grads["B"] = fe.grad_factors_mttkrp(params, toks, dY, V)
            params, state, _ = optim.apply_updates(cfg, params, grads, state)
        return params

    with_b1f, with_autograd = adamw_steps(True), adamw_steps(False)
    adamw_err = {k: rel_err(with_b1f[k], with_autograd[k]) for k in "ABC"}
    check(max(adamw_err.values()) <= 1e-5, f"embed: AdamW on B1f's gradients off by "
                                           f"{adamw_err}")
    moved = {k: rel_err(with_autograd[k], p[k]) for k in "ABC"}
    check(min(moved.values()) > 0, f"embed: AdamW left a factor unchanged {moved}")
    return {"phase": "embed", "model": "qwen1.5-4b", "vocab": EMBED_VOCAB,
            "padded_vocab": V, "factor_vocab": list(fe.factor_vocab(V)),
            "d_model": EMBED_D, "rank": EMBED_RANK, "batch": list(EMBED_BATCH),
            "zipf_exponent": EMBED_ZIPF, "kappa": EMBED_KAPPA,
            "unique_tokens": int(torch.unique(toks).numel()),
            "generate_s": gen_s, "launches": launches,
            "lookup_rel_err": lookup_err, "dense_table_bytes": table_bytes,
            "batch_tensor_ms": batch_ms, "make_plan_ms": make_plan_ms,
            "pack_upload_ms": pack_ms, "modes": modes,
            "b1f_ms": sum(m["ms"] for m in modes),
            "b1f_device_ms": sum(m["pass_one_ms"] + m["pass_two_ms"] for m in modes),
            "b1f_plain_ms": sum(m["plain_ms"] for m in modes),
            "b1f_bound_ms": sum(m["bound_ms"] for m in modes),
            "library_ms": library_ms, "library": "torch.autograd.grad of the lookup",
            "grad_step": step, "adamw_steps": EMBED_ADAMW_STEPS,
            "adamw_rel_err": adamw_err, "adamw_moved": moved}


def lm_phase(torch, np, clock, ks, dev):
    """The LM serving path at full width: qwen1.5-4b with random weights
    from a seed, through the launcher's ``generate`` and ``get_model``.
    Gates: float32 decode against ``forward`` (the reference's 5e-4);
    bfloat16, the config's dtype, made by casting the same parameters
    (5e-2); the int8 cache teacher-forced with the bf16 run's tokens
    against it (0.05 every step, argmax on 95% of the pairs); the
    CPD-factorized embedding (rank 256) in float32 (5e-4, and its lookup
    against the dense table at 1e-5); every decode loop under
    ``torch.cuda.set_sync_debug_mode("error")``, which ``generate`` sets.
    Then the bf16 run's times, its byte bound and the idle share of
    decode steps."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import factorized_embed as fe
    from repro_torch.models import get_model
    from repro_torch.models.common import build_params

    B, P, G = LM_BATCH, LM_PROMPT, LM_GEN
    cfg16 = get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    model32, model16 = get_model(cfg32), get_model(cfg16)
    t0 = clock.now()
    params32 = model32.init(torch.Generator(device=dev).manual_seed(0), dev)
    prompts = torch.randint(0, cfg16.vocab_size, (B, P), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    init_s = clock.now() - t0
    reset_launches(ks)

    # Gate 5's control: on this build the debug mode stops a host read.
    caught = False
    with serve.no_host_sync(dev):
        try:
            torch.zeros(1, device=dev).item()
        except RuntimeError:
            caught = True
    check(caught, "lm: set_sync_debug_mode('error') let a host read through")

    def run(model, params, **kw):
        logits = []
        t0 = clock.now()
        out = serve.generate(model, params, prompts, G, logits_out=logits, **kw)
        out["wall_s"] = clock.now() - t0
        check(out["tokens"].shape == (B, G), f"lm: tokens of shape {out['tokens'].shape}")
        check(all(bool(torch.isfinite(x).all()) for x in logits), "lm: non-finite logits")
        return out, logits

    def vs_forward(model, params, out, logits) -> tuple[dict, float]:
        """Each checked step's decode logits against ``forward`` on the
        served sequence (position P - 1 + t holds step t's logits), and the
        share of all (sequence, step) pairs whose served token is the
        argmax of ``forward``'s logits."""
        seq = torch.cat([prompts, torch.as_tensor(out["tokens"][:, :-1], device=dev)], 1)
        full, _ = model.forward(params, seq)
        errs = {t: rel_err(logits[t].float(), full[:, P - 1 + t].float())
                for t in LM_CHECK_STEPS}
        same = float((torch.argmax(full[:, P - 1:], -1).cpu().numpy()
                      == out["tokens"]).mean())
        del full
        return errs, same

    def times(out) -> dict:
        return {k: out[k] for k in ("prefill_ms", "decode_ms_per_token", "tokens_per_s",
                                    "wall_s")}

    # Gate 1: float32 through.
    out32, logits32 = run(model32, params32)
    f32_err, f32_same = vs_forward(model32, params32, out32, logits32)
    check(max(f32_err.values()) < 5e-4, f"lm: float32 decode vs forward {f32_err}")
    del logits32

    # Gate 4: the CPD-factorized embedding, the same blocks and unembedding.
    cfg_cpd = dataclasses.replace(cfg32, cpd_embed_rank=LM_CPD_RANK)
    model_cpd = get_model(cfg_cpd)
    V = cfg_cpd.padded_vocab
    params_cpd = {k: v for k, v in params32.items() if k != "embed"}
    params_cpd["embed_cpd"] = build_params(
        fe.cpd_embed_specs(V, cfg_cpd.d_model, LM_CPD_RANK),
        torch.Generator(device=dev).manual_seed(2), torch.float32, device=dev)
    table = fe.dense_table(params_cpd["embed_cpd"], V)
    lookup_err = rel_err(fe.cpd_embed_lookup(params_cpd["embed_cpd"], prompts, V),
                         table[prompts.long()])
    del table
    check(lookup_err <= 1e-5, f"lm: the CPD lookup differs from the dense table by "
                              f"{lookup_err}")
    out_cpd, logits_cpd = run(model_cpd, params_cpd)
    cpd_err, cpd_same = vs_forward(model_cpd, params_cpd, out_cpd, logits_cpd)
    check(max(cpd_err.values()) < 5e-4, f"lm: CPD-embedding decode vs forward {cpd_err}")
    del logits_cpd, params_cpd

    # Gate 2: bfloat16, cast from the same parameters; a warm run first.
    params16 = _to_float(params32, torch.bfloat16)
    del params32
    torch.cuda.empty_cache()
    warm, _ = run(model16, params16)
    out16, logits16 = run(model16, params16)
    bf16_err, bf16_same = vs_forward(model16, params16, out16, logits16)
    check(max(bf16_err.values()) < 5e-2, f"lm: bfloat16 decode vs forward {bf16_err}")

    # Gate 3: the int8 cache, fed the bf16 run's tokens, against that run.
    # The argmax share is gated at LM_INT8_ARGMAX: with random weights the
    # top logits of a 152,064-entry vocabulary are often within the int8
    # cache's 2-3% error of each other (the reference's design: int8
    # values, dequantized in bf16).  On the H100 a correct run kept 0.946
    # of these 504 pairs (binomial sd 0.010), about as many as bf16's own
    # rounding keeps between decode and ``forward`` (0.936), so 0.95
    # would fail about half of correct runs; a wrong position or scale
    # reads near 1 in ``q_err`` and near 0 here.
    forced = torch.as_tensor(out16["tokens"][:, :-1], device=dev)
    out8, logits8 = run(model16, params16, quant_kv=True, forced=forced)
    q_err = [rel_err(logits8[t].float(), logits16[t].float()) for t in range(1, G)]
    argmax8 = torch.stack([torch.argmax(logits8[t], -1) for t in range(1, G)], 1)
    agree = float((argmax8.cpu().numpy() == out16["tokens"][:, 1:]).mean())
    check(max(q_err) < 0.05, f"lm: int8 cache vs native, largest step {max(q_err)}")
    check(agree >= LM_INT8_ARGMAX, f"lm: int8 cache keeps the argmax on {agree} of the "
                                   f"pairs, under {LM_INT8_ARGMAX}")
    del logits16, logits8

    # The byte bound of one bf16 decode step: every parameter and the
    # whole KV buffer read once.
    param_bytes = sum(x.numel() * x.element_size() for x in _leaves(params16))
    kv_bytes = 2 * cfg16.num_layers * B * (P + G) * cfg16.num_kv_heads * cfg16.head_dim * 4
    bound_ms = (param_bytes + kv_bytes) / hw_peak("hbm_bw") * 1e3

    # The idle share of LM_IDLE_STEPS decode steps after a prefill.
    cache = model16.init_cache(B, P + G, dtype=torch.float32, device=dev)
    logits, cache = model16.prefill(params16, prompts, cache)
    state = {"tok": steps.greedy(logits), "cache": cache}
    decode = steps.make_decode_step(model16)

    def decode_steps():
        for _ in range(LM_IDLE_STEPS):
            state["tok"], state["cache"] = decode(params16, state["cache"],
                                                  {"tokens": state["tok"][:, None]})

    decode_steps()
    idle = device_idle(torch, decode_steps, clock)
    launches = dict(ks.LAUNCHES)
    check(all(n == 0 for n in launches.values()),
          f"lm: the LM path launched the port's kernels {launches}")
    del params16, state, cache, logits
    ms = out16["decode_ms_per_token"]
    return {"phase": "lm", "arch": LM_ARCH, "layers": cfg16.num_layers,
            "d_model": cfg16.d_model, "heads": cfg16.num_heads,
            "kv_heads": cfg16.num_kv_heads, "head_dim": cfg16.head_dim,
            "d_ff": cfg16.d_ff, "vocab": cfg16.vocab_size, "padded_vocab": V,
            "param_count": cfg16.param_count(), "batch": B, "prompt": P, "gen": G,
            "cache_dtype": "float32", "kv_cache_bytes": kv_bytes, "init_s": init_s,
            "sync_debug_control": caught,
            "float32": {**times(out32), "decode_vs_forward": f32_err,
                        "tokens_are_forward_argmax": f32_same},
            "cpd_embed": {"rank": LM_CPD_RANK, "factor_vocab": list(fe.factor_vocab(V)),
                          "lookup_rel_err": lookup_err, **times(out_cpd),
                          "decode_vs_forward": cpd_err,
                          "tokens_are_forward_argmax": cpd_same},
            "bfloat16_warm": times(warm),
            "bfloat16": {**times(out16), "decode_vs_forward": bf16_err,
                         "tokens_are_forward_argmax": bf16_same,
                         "param_bytes": param_bytes, "bound_ms": bound_ms,
                         "decode_over_bound": ms / bound_ms,
                         "idle_steps": LM_IDLE_STEPS, "decode_steps_idle": idle},
            "int8_kv": {**times(out8), "rel_err_by_step": q_err,
                        "max_rel_err": max(q_err), "argmax_agreement": agree},
            "launches": launches}


def _cast_like(tree, abstract):
    """``tree``'s tensors cast to the dtypes of ``abstract`` (a model's
    ``abstract_params()``): a MoE router stays float32 in a bf16 model."""
    if isinstance(tree, dict):
        return {k: _cast_like(v, abstract[k]) for k, v in tree.items()}
    return tree.to(abstract.dtype)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree)
               if hasattr(x, "element_size"))


def decode_read_bytes(cfg, params, cache, batch: int) -> int:
    """The bytes one decode step must read: every parameter it uses (not
    the encoder, not the meta tokens, and of an untied embedding table
    only the batch's rows) and the whole cache (KV buffers and rings, the
    SSM state and conv window, Whisper's cross KV)."""
    used = {k: v for k, v in params.items()
            if k not in ("enc", "enc_norm", "meta_tokens", "embed")}
    n = _nbytes(used) + _nbytes(cache)
    emb = params.get("embed")
    if emb is not None:
        n += (emb.numel() if cfg.tie_embeddings else batch * emb.shape[1]) \
            * emb.element_size()
    return n


def _to_float(tree, dtype):
    """``tree`` (parameters or a cache) with its floating tensors in
    ``dtype``; integer tensors (an int8 cache) and ints kept."""
    return _map_leaves(tree, lambda x: x.to(dtype) if getattr(
        x, "is_floating_point", lambda: False)() else x)


@contextlib.contextmanager
def routed_experts(ids: list):
    """Inside, every MoE routing appends its expert ids (B, S, k) to
    ``ids``, one entry a layer."""
    from repro_torch.models import mlp

    route = mlp._route

    def spy(cfg, p, x):
        out = route(cfg, p, x)
        ids.append(out[2])
        return out

    mlp._route = spy
    try:
        yield ids
    finally:
        mlp._route = route


def expert_flips(torch, a, b, num_experts: int) -> float:
    """The share of the top-k expert choices in ``a`` that ``b`` (both
    (B, S, k)) does not make."""
    def onehot(ids):
        return torch.zeros(ids.shape[:-1] + (num_experts,), device=ids.device).scatter_(
            -1, ids, 1.0)
    return float((onehot(a) * (1 - onehot(b))).sum() / a.numel())


def row_rel(torch, a, b):
    """``rel_err`` of each row (the logits of one sequence at one step)."""
    a, b = a.double().flatten(0, -2), b.double().flatten(0, -2)
    return (a - b).abs().amax(-1) / b.abs().amax(-1)


@contextlib.contextmanager
def float64_compute(torch):
    """Inside, ``Tensor.float()`` leaves a float64 tensor as it is: the
    models upcast to float32 where the reference asks for float32
    products, so a model given float64 parameters and cache then computes
    in float64 throughout (every other dtype is upcast as before)."""
    upcast = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: (
        self if self.dtype == torch.float64 else upcast(self, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = upcast


def family_phase(torch, np, clock, ks, dev, name, arch, B, P, G):
    """One LM family at full width with random weights from a seed (the
    reference's initialization), through ``get_model`` and the launcher's
    ``generate`` (batch B, prompt P, G tokens, a float32 cache; Whisper
    with 0.1 x normal encoder frames, as the reference's launcher draws
    them).  The float32 run serves greedily; the bf16 run (the config's
    dtype, cast from the same parameters) and hymba's int8 cache decode
    that same sequence, teacher-forced.  The exact function is the same
    parameters in float64 (``float64_compute``).

    Gates: float64 decode against float64 ``forward`` on the served
    sequence below 1e-9 (the decode path is the forward's function:
    caches, rings, SSM state, cross KV); float32 decode within the
    reference's 5e-4 of the float64 forward; bf16 decode against bf16
    ``forward``, bf16 ``forward`` against float64 and hymba's int8 cache
    against the bf16 decode at the family's ``FAMILY_LIMITS``; no host
    read in a decode loop; no launch of the port's kernels.  Also
    printed: the float32 decode against its own ``forward`` (the
    reference test's measure), the rows' median ``rel`` of bf16 against
    float64, for MoE the share of router choices that bf16 changes in
    each layer, the bf16 times beside the byte bound of a decode step,
    the idle share of decode steps and the peak memory."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve, steps
    from repro_torch.models import get_model

    cfg16 = dataclasses.replace(configs.get_config(arch), **FAMILY_DEPTH.get(name, {}))
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    model32, model16 = get_model(cfg32), get_model(cfg16)
    encdec = cfg16.family == "encdec"
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()   # the memory statistics need the allocator up
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = clock.now()
    params32 = model32.init(torch.Generator(device=dev).manual_seed(0), dev)
    prompts = torch.randint(0, cfg16.vocab_size, (B, P), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    kw = {}
    if encdec:
        kw["encoder_embeds"] = 0.1 * torch.randn(
            (B, cfg16.enc_seq, cfg16.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    init_s = clock.now() - t0
    reset_launches(ks)
    check_steps = sorted({1, G // 3, 2 * G // 3, G - 1})

    def run(model, params, **extra):
        logits = []
        t0 = clock.now()
        out = serve.generate(model, params, prompts, G, logits_out=logits, **kw, **extra)
        out["wall_s"] = clock.now() - t0
        check(out["tokens"].shape == (B, G), f"{name}: tokens of shape {out['tokens'].shape}")
        check(all(bool(torch.isfinite(x).all()) for x in logits), f"{name}: non-finite logits")
        return out, logits

    def times(out) -> dict:
        return {k: out[k] for k in ("prefill_ms", "decode_ms_per_token", "tokens_per_s",
                                    "wall_s")}

    out32, logits32 = run(model32, params32)
    served = torch.as_tensor(out32["tokens"], device=dev)
    seq = torch.cat([prompts, served[:, :-1]], 1)

    def forward(model, params, kwd):
        """``forward``'s logits on the served sequence, at every decode step
        (position P - 1 + t holds step t's)."""
        full, _ = (model.forward(params, seq, kwd["encoder_embeds"]) if encdec
                   else model.forward(params, seq))
        return full[:, P - 1:].clone()

    def errs(dec, full) -> dict:
        return {t: rel_err(dec[t].double(), full[:, t].double()) for t in check_steps}

    def argmax_share(a, b) -> float:
        return float((torch.argmax(a, -1) == torch.argmax(b, -1)).float().mean())

    moe = cfg16.family == "moe"
    ids64, ids16 = [], []
    # The exact function: the same parameters in float64, its forward and
    # its decode teacher-forced with the served tokens.
    with float64_compute(torch):
        p64, kw64 = _to_float(params32, torch.float64), _to_float(kw, torch.float64)
        with routed_experts(ids64 if moe else []):
            truth = forward(model32, p64, kw64)
        cache = _to_float(model32.init_cache(B, P + G, dtype=torch.float32, device=dev),
                          torch.float64)
        logits, cache = model32.prefill(p64, prompts, cache, **kw64)
        dec64 = [logits[:, -1]]
        with serve.no_host_sync(dev):
            for t in range(1, G):
                logits, cache = model32.decode_step(p64, served[:, t - 1:t], cache)
                dec64.append(logits[:, -1])
        f64_err = errs(dec64, truth)
        del dec64, cache, logits, p64
    check(max(f64_err.values()) < 1e-9, f"{name}: float64 decode vs forward {f64_err}")

    f32_err = errs(logits32, forward(model32, params32, kw))
    f32_truth = errs(logits32, truth)
    check(max(f32_truth.values()) < 5e-4,
          f"{name}: float32 decode vs float64 forward {f32_truth}")
    del logits32
    params16 = _cast_like(params32, model16.abstract_params())
    del params32
    if cuda:
        torch.cuda.empty_cache()

    lim = FAMILY_LIMITS[name]
    forced = served[:, :-1]
    out16, logits16 = run(model16, params16, forced=forced)
    with routed_experts(ids16 if moe else []):
        full16 = forward(model16, params16, kw)
    bf16_err, bf16_truth = errs(logits16, full16), errs(logits16, truth)
    bf16_fwd_truth = errs(full16.unbind(1), truth)
    dec16 = torch.stack(logits16[1:], 1)                          # (B, G - 1, V)
    bf16_same = argmax_share(dec16, full16[:, 1:])
    f64_same = argmax_share(full16, truth)
    f64_median = float(row_rel(torch, full16, truth).median())
    flips = [expert_flips(torch, a, b, cfg16.num_experts) for a, b in zip(ids16, ids64)]
    del full16, ids16, ids64
    check(max(bf16_err.values()) < lim["bf16"],
          f"{name}: bfloat16 decode vs forward {bf16_err}, limit {lim['bf16']}")
    check(bf16_same >= lim["bf16_argmax"],
          f"{name}: bfloat16 decode keeps forward's argmax on {bf16_same} of the pairs, "
          f"under {lim['bf16_argmax']}")
    check(f64_median < lim["f64_median"],
          f"{name}: bfloat16 forward vs float64, the rows' median {f64_median}, "
          f"limit {lim['f64_median']}")
    check(f64_same >= lim["f64_argmax"],
          f"{name}: bfloat16 forward keeps float64's argmax on {f64_same} of the pairs, "
          f"under {lim['f64_argmax']}")

    int8 = None
    if cfg16.family == "hybrid":
        out8, logits8 = run(model16, params16, quant_kv=True, forced=forced)
        q_err = [rel_err(logits8[t].float(), logits16[t].float()) for t in range(1, G)]
        agree = argmax_share(torch.stack(logits8[1:], 1), torch.stack(logits16[1:], 1))
        check(max(q_err) < lim["int8"], f"{name}: int8 cache vs native, largest step "
                                        f"{max(q_err)}, limit {lim['int8']}")
        check(agree >= lim["int8_argmax"], f"{name}: int8 cache keeps the argmax on {agree} "
                                           f"of the pairs, under {lim['int8_argmax']}")
        int8 = {**times(out8), "rel_err_by_step": q_err, "max_rel_err": max(q_err),
                "argmax_agreement": agree, "vs_float64": errs(logits8, truth)}
        del logits8
    del logits16, dec16, truth

    # The idle share of LM_IDLE_STEPS bf16 decode steps after a prefill, and
    # the byte bound of one such step.
    cache = model16.init_cache(B, P + G, dtype=torch.float32, device=dev)
    logits, cache = model16.prefill(params16, prompts, cache, **kw)
    state = {"tok": steps.greedy(logits), "cache": cache}
    decode = steps.make_decode_step(model16)
    read_bytes = decode_read_bytes(cfg16, params16, cache, B)
    bound_ms = read_bytes / hw_peak("hbm_bw") * 1e3

    def decode_steps():
        for _ in range(LM_IDLE_STEPS):
            state["tok"], state["cache"] = decode(params16, state["cache"],
                                                  {"tokens": state["tok"][:, None]})

    decode_steps()
    idle = device_idle(torch, decode_steps, clock)
    launches = dict(ks.LAUNCHES)
    check(all(n == 0 for n in launches.values()),
          f"{name}: the LM path launched the port's kernels {launches}")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    param_bytes = _nbytes(params16)
    del params16, state, cache, logits
    ms = out16["decode_ms_per_token"]
    return {"phase": name, "arch": arch, "family": cfg16.family,
            "layers": cfg16.num_layers, "enc_layers": cfg16.enc_layers,
            "d_model": cfg16.d_model, "vocab": cfg16.vocab_size,
            "param_count": cfg16.param_count(), "param_bytes_bf16": param_bytes,
            "batch": B, "prompt": P, "gen": G, "cache_dtype": "float32",
            "positions": P + G + cfg16.num_meta_tokens,
            "attn_window": cfg16.attn_window, "init_s": init_s, "limits": lim,
            "float64": {"decode_vs_forward": f64_err},
            "float32": {**times(out32), "decode_vs_forward": f32_err,
                        "decode_vs_float64": f32_truth},
            "bfloat16": {**times(out16), "decode_vs_forward": bf16_err,
                         "decode_vs_float64": bf16_truth,
                         "forward_vs_float64": bf16_fwd_truth,
                         "forward_vs_float64_row_median": f64_median,
                         "forward_argmax_is_float64_argmax": f64_same,
                         "router_choices_changed_by_layer": flips or None,
                         "decode_argmax_is_forward_argmax": bf16_same,
                         "decode_read_bytes": read_bytes, "bound_ms": bound_ms,
                         "decode_over_bound": ms / bound_ms,
                         "idle_steps": LM_IDLE_STEPS, "decode_steps_idle": idle},
            "int8_kv": int8, "peak_memory_bytes": peak, "launches": launches}


def _tree_pairs(a, b):
    """The leaf pairs of two trees of one structure."""
    if isinstance(a, dict):
        return [p for k in a for p in _tree_pairs(a[k], b[k])]
    return [(a, b)]


def grad_rel(torch, g, ref) -> float:
    """Global relative norm |g - ref| / |ref| over every leaf (float64)."""
    pairs = _tree_pairs(g, ref)
    num = sum(float((x.double() - y.double()).square().sum()) for x, y in pairs)
    den = sum(float(y.double().square().sum()) for _, y in pairs)
    return (num / den) ** 0.5


def train_bounds(cfg, tokens: int, params) -> dict:
    """The least time of one train step: 6 N T operations for the forward
    and backward plus 2 N T for the forward that ``remat`` recomputes, at
    the card's dense bf16 rate, N the parameters a token meets (of a MoE
    layer's experts the top k; attention's own products not counted); and
    the bytes AdamW must move: parameters and gradients (of the
    parameters' dtype) read, parameters written, both float32 moments read
    and written."""
    n = cfg.param_count()
    active = n - cfg.num_layers * (cfg.num_experts - cfg.num_experts_per_tok) \
        * 3 * cfg.d_model * cfg.moe_dff if cfg.num_experts else n
    ops = (6 + (2 if cfg.remat != "none" else 0)) * active * tokens
    numel = sum(x.numel() for x in _leaves(params))
    bytes_ = 3 * _nbytes(params) + 4 * 4 * numel
    flop_ms = ops / hw_peak("peak_flops_bf16") * 1e3
    byte_ms = bytes_ / hw_peak("hbm_bw") * 1e3
    return {"active_params": active, "operations": ops, "flop_bound_ms": flop_ms,
            "adamw_bytes": bytes_,
            "byte_bound_ms": byte_ms, "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def step_records(trainer, peaks, tokens) -> dict:
    """Each step of ``trainer.history`` (loss, CUDA-event ms, tokens/s, wall
    ms, peak memory) and the trainer's host reads a step: its one read of
    the loss and gradient norm, the step itself running under
    ``set_sync_debug_mode("error")``, where any other read raises."""
    steps = [{"step": r["step"], "loss": r["loss"], "grad_norm": r["grad_norm"],
              "ms": r.get("device_ms"), "wall_ms": r["time_s"] * 1e3,
              "tokens_per_s": tokens / (r["device_ms"] / 1e3) if r.get("device_ms") else None,
              "straggler": r["straggler"], "peak_memory_bytes": pk}
             for r, pk in zip(trainer.history, peaks)]
    return {"steps": steps, "host_reads_per_step": trainer.host_reads / len(steps),
            "step_sync_guard": trainer.sync_guard}


@contextlib.contextmanager
def forced_routing(torch, ids: list):
    """Inside, the i-th MoE routing takes ``ids[i]`` (B, S, k) as its expert
    choices, its gates renormalized from its own probabilities at them and
    its load-balance loss counted from them: the discrete branch of the run
    that recorded ``ids`` (``routed_experts``), in this run's precision."""
    from repro_torch.models import mlp

    route = mlp._route
    choices = iter(ids)

    def forced(cfg, p, x):
        probs = route(cfg, p, x)[0]
        expert = next(choices)
        gate = torch.gather(probs, -1, expert)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        counts = torch.zeros((cfg.num_experts,), dtype=torch.float32, device=x.device)
        counts.index_add_(0, expert.reshape(-1), torch.ones(expert.numel(), device=x.device))
        aux = cfg.num_experts * torch.sum(probs.mean(dim=(0, 1)) * counts / expert.numel())
        return probs, gate, expert, aux

    mlp._route = forced
    try:
        yield
    finally:
        mlp._route = route


def step_cost_of_determinism(torch, model, opt_cfg, state, batch) -> dict:
    """CUDA-event ms of one train step with PyTorch's deterministic kernels
    and without, in turns (with, without, without, with; each turn the
    median of 2 steps after one more), on the same state."""
    from repro_torch.launch import steps

    fns = {"deterministic": steps.make_train_step(model, opt_cfg, deterministic=True),
           "default": steps.make_train_step(model, opt_cfg, deterministic=False)}
    out = {"deterministic": [], "default": []}
    for label in ("deterministic", "default", "default", "deterministic"):
        out[label].append(cuda_ms(torch, lambda f=fns[label]: f(*state, batch), 2))
    return out


def float32_vs_float64(torch, dev, model, params, batch, arch):
    """The train step's gradient (``steps.make_grad_fn``, with the step's
    deterministic kernels) of ``params`` cast to float32 and to float64 on
    ``batch``, in a float32 model (``float64_compute`` keeps the float64
    one float64 through); returns the global relative norm of their
    difference and, for MoE, the share of the router's choices that
    float32 makes and float64 does not, per layer (forward only: with
    remat the backward routes each layer again).  A flipped choice moves
    a token to another expert, a jump in the function that no precision
    bounds, so a MoE model's gate is float32's gradient on float64's
    routing (``forced_routing``); the gradient on its own routing is
    printed beside it."""
    import dataclasses

    from repro_torch.device import deterministic_algorithms
    from repro_torch.launch import steps
    from repro_torch.models import get_model

    model32 = get_model(dataclasses.replace(model.cfg, dtype="float32"))
    grad_fn = steps.make_grad_fn(model32)

    def grad(p, b):
        with deterministic_algorithms():
            return grad_fn(p, b)

    moe = model.cfg.family == "moe"
    ids32, ids64 = [], []
    p32 = _to_float(params, torch.float32)
    g32, m32 = grad(p32, batch)
    if moe:
        with torch.no_grad(), routed_experts(ids32), deterministic_algorithms():
            model32.loss(p32, batch)
    with float64_compute(torch):
        p64 = _to_float(params, torch.float64)
        g64, m64 = grad(p64, batch)
        if moe:
            with torch.no_grad(), routed_experts(ids64), deterministic_algorithms():
                model32.loss(p64, batch)
        del p64
    rel = grad_rel(torch, g32, g64)
    zero = grad_rel(torch, _map_leaves(g32, torch.zeros_like), g64)
    flips = [expert_flips(torch, a, b, model.cfg.num_experts) for a, b in zip(ids32, ids64)]
    out = {"grad_rel_norm": rel, "zeros_rel_norm": zero,
           "loss_float32": float(m32["loss"]), "loss_float64": float(m64["loss"]),
           "router_choices_changed_by_layer": flips or None}
    del g32
    gated = rel
    if moe:
        # float32 on float64's routing: one routing a layer, in order, so
        # without remat (whose backward routes each layer again).
        plain = get_model(dataclasses.replace(model.cfg, dtype="float32", remat="none"))
        with forced_routing(torch, ids64), deterministic_algorithms():
            g_same, _ = steps.make_grad_fn(plain)(p32, batch)
        gated = out["grad_rel_norm_on_float64_routing"] = grad_rel(torch, g_same, g64)
        del g_same
    del p32, g64, ids32, ids64
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    limit = TRAIN_GRAD_LIMITS[arch]
    check(gated < limit, f"train: {arch} float32 gradient vs float64 {gated}, limit {limit}")
    return out


def make_train(dev, arch, ckpt=None):
    """``launch.train``'s trainer for ``arch`` with the launcher's defaults
    (batch, tokens, the schedule of its default steps; parameters from
    seed 0), checkpointing into ``ckpt`` every TRAIN_CKPT_EVERY steps."""
    from repro_torch.launch import train

    return train.make_trainer(arch, steps=TRAIN_SCHEDULE_STEPS, batch=TRAIN_BATCH,
                              seq=TRAIN_SEQ, ckpt=None if ckpt is None else str(ckpt),
                              ckpt_every=TRAIN_CKPT_EVERY, device=dev)


def first_batch(torch, dev, trainer) -> dict:
    """The first batch of ``trainer``'s pipeline, from a copy of it."""
    from repro_torch.data import TokenPipeline

    p = trainer.pipeline
    pipe = TokenPipeline(p.vocab, p.batch, p.seq, seed=p.state.seed)
    return {k: torch.as_tensor(v, device=dev) for k, v in next(pipe).items()}


def train_phase(torch, np, clock, ks, dev):
    """LM training through ``launch.train``'s code path (``make_trainer``,
    ``Trainer``, the token pipeline, ``steps.make_train_step``).

    internvl2-1b at full width (the launcher's default arch and run):
    TRAIN_STEPS steps with a checkpoint at TRAIN_CKPT_EVERY, then a new
    trainer on that checkpoint alone.  Gates: the restart's losses are the
    uninterrupted run's bitwise; the first step's loss is ``model.loss`` of
    the initial parameters outside the step, bitwise; the float32 gradient
    within TRAIN_GRAD_LIMITS of float64; every loss finite.  Printed: each
    step's ms (CUDA events), tokens/s, host reads, peak memory; the step's
    FLOP and byte bounds; one step's idle share under ``torch.profiler``;
    the step with PyTorch's deterministic kernels and without.

    granite-moe-1b at full width, the MoE capacity dispatch that serving
    never runs: TRAIN_MOE_STEPS steps, the same numbers, finite losses, the
    float32 gradient against float64 and the router choices float32
    changes.  Then ``examples/factorized_embedding_torch.py``'s two runs
    on the card: both losses fall.  No launch of the port's kernels."""
    import importlib.util
    import shutil

    from repro_torch.launch import steps

    cuda = dev.type == "cuda"
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    reset_launches(ks)

    def peak_hook(peaks):
        def hook(step):
            if cuda:
                peaks.append(torch.cuda.max_memory_allocated(dev))
                torch.cuda.reset_peak_memory_stats(dev)
            else:
                peaks.append(None)
        return hook

    # -- internvl2-1b: 6 steps, a checkpoint at 3, a restart from it ----------
    if cuda:
        torch.cuda.init()   # the memory statistics need the allocator up
        torch.cuda.reset_peak_memory_stats(dev)
    tr = make_train(dev, TRAIN_ARCH, ckpt)
    check(tr.initialize() == "initialized", "train: restored from a stale checkpoint")
    batch0, params0 = first_batch(torch, dev, tr), tr.params
    model, cfg = tr.model, tr.model.cfg
    with torch.no_grad():
        loss0 = float(model.loss(params0, batch0)[0])
    peaks = []
    tr.failure_hook = peak_hook(peaks)
    t0 = clock.now()
    hist = tr.run(TRAIN_STEPS, log=lambda msg: None)
    run_s = clock.now() - t0
    losses = [r["loss"] for r in hist]
    check(all(np.isfinite(losses)), f"train: {TRAIN_ARCH} losses {losses}")
    check(losses[0] == loss0, f"train: the first step's loss {losses[0]} is not "
                              f"model.loss of the initial parameters {loss0}")
    check(tr.host_reads == TRAIN_STEPS, f"train: {tr.host_reads} host reads in "
                                        f"{TRAIN_STEPS} steps")
    records = step_records(tr, peaks, tokens)
    bounds = train_bounds(cfg, tokens, tr.params)

    # The restart: the step-3 checkpoint alone, a new trainer on it.
    tr.ckpt.wait()
    for name in (f"step_{TRAIN_STEPS}", f"step_{TRAIN_STEPS}.done"):
        path = ckpt / name
        shutil.rmtree(path) if path.is_dir() else path.unlink()
    del tr
    tr2 = make_train(dev, TRAIN_ARCH, ckpt)
    t0 = clock.now()
    check(tr2.initialize() == "restored" and tr2.step == TRAIN_CKPT_EVERY,
          f"train: the restart did not restore step {TRAIN_CKPT_EVERY}")
    restore_s = clock.now() - t0
    again = [r["loss"] for r in tr2.run(TRAIN_STEPS, log=lambda msg: None)]
    check(again == losses[TRAIN_CKPT_EVERY:],
          f"train: the restart's losses {again} are not the run's {losses[TRAIN_CKPT_EVERY:]}")

    # One step under the profiler, and the step with and without determinism.
    idle = device_idle(torch, tr2.train_one, clock) if cuda else None
    det = (step_cost_of_determinism(torch, model, tr2.opt_cfg, (tr2.params, tr2.opt_state),
                                    batch0) if cuda else None)
    del tr2
    shutil.rmtree(ckpt, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    grads = float32_vs_float64(torch, dev, model, params0, batch0, TRAIN_ARCH)
    del params0, batch0
    if cuda:
        torch.cuda.empty_cache()
    vlm = {"arch": TRAIN_ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "padded_vocab": cfg.padded_vocab,
           "param_count": cfg.param_count(), "dtype": cfg.dtype, "remat": cfg.remat,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, **records, "run_s": run_s,
           "first_loss_outside_the_step": loss0, "restart_losses": again,
           "restore_s": restore_s, **bounds, "step_idle": idle,
           "step_ms_deterministic_vs_default": det, "float32_vs_float64": grads}

    # -- granite-moe-1b: the capacity dispatch in training ----------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    tr = make_train(dev, TRAIN_MOE_ARCH)
    tr.initialize()
    batch0, params0 = first_batch(torch, dev, tr), tr.params
    model, cfg = tr.model, tr.model.cfg
    peaks = []
    tr.failure_hook = peak_hook(peaks)
    hist = tr.run(TRAIN_MOE_STEPS, log=lambda msg: None)
    losses = [r["loss"] for r in hist]
    check(all(np.isfinite(losses)), f"train: {TRAIN_MOE_ARCH} losses {losses}")
    records = step_records(tr, peaks, tokens)
    bounds = train_bounds(cfg, tokens, tr.params)
    idle = device_idle(torch, tr.train_one, clock) if cuda else None
    det = (step_cost_of_determinism(torch, model, tr.opt_cfg, (tr.params, tr.opt_state),
                                    batch0) if cuda else None)
    del tr
    if cuda:
        torch.cuda.empty_cache()
    grads = float32_vs_float64(torch, dev, model, params0, batch0, TRAIN_MOE_ARCH)
    del params0, batch0
    moe = {"arch": TRAIN_MOE_ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
           "param_count": cfg.param_count(), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           **records, **bounds, "step_idle": idle,
           "step_ms_deterministic_vs_default": det, "float32_vs_float64": grads}

    # -- the factorized-embedding example on the card ----------------------------
    spec = importlib.util.spec_from_file_location(
        "factorized_embedding_torch", ROOT / "examples" / "factorized_embedding_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = clock.now()
    rows = example.main(["--device", str(dev)])
    example_s = clock.now() - t0
    for row in rows:
        first, last = np.mean(row["losses"][:5]), np.mean(row["losses"][-5:])
        check(last < first, f"train: the example's {row['label']} loss {first} -> {last}")
        row["loss_first5_mean"], row["loss_last5_mean"] = float(first), float(last)
        row["step_ms_median"] = statistics.median(row.pop("step_s")) * 1e3
        row["losses"] = [row["losses"][0], row["losses"][-1]]

    launches = dict(ks.LAUNCHES)
    check(all(n == 0 for n in launches.values()),
          f"train: the training path launched the port's kernels {launches}")
    return {"phase": "train", TRAIN_ARCH: vlm, TRAIN_MOE_ARCH: moe,
            "factorized_embedding_example": {"runs": rows, "wall_s": example_s},
            "launches": launches}


def dryrun_phase(torch, np, clock, ks, dev):
    """The dry run's table and counts held to the card.

    (a) The H100 table ``launch.mesh.HW`` against the card: its SM count
    equal, its memory at least ``HW["hbm_bytes"]``.  (b) One train step of
    the ``train`` phase's shape (TRAIN_ARCH with the launcher's edits,
    TRAIN_BATCH x TRAIN_SEQ, bf16, remat, one rank) counted by the dry
    run's own functions (``dryrun._build``, ``dryrun._run``) on ``meta``,
    then under the same ``OpCounter`` on the card with parameters from
    seed 0.  Gates: FLOPs and bytes equal; the card's peak allocation over
    the step (above what was allocated before its inputs) within
    DRYRUN_MEMORY_RATIO of the dry run's peak live bytes.  Printed: the
    step's bound from the counts and ``HW`` beside ``train_bounds``' and
    the step's CUDA-event ms.  (c) One bf16 decode step of LM_ARCH at the
    ``lm`` phase's shape (LM_BATCH, a cache of LM_PROMPT + LM_GEN
    positions) counted the same two ways.  Gates: bytes equal, and at
    least ``decode_read_bytes``.  No launch of the port's kernels."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HW, AbstractMesh
    from repro_torch.launch.op_analysis import roofline_terms
    from repro_torch.models import ShapeCfg, get_model

    reset_launches(ks)
    props = torch.cuda.get_device_properties(dev)
    table = {"sm_count": props.multi_processor_count, "total_memory": props.total_memory,
             "hw_sm_count": HW["sm_count"], "hw_hbm_bytes": HW["hbm_bytes"],
             "nvidia_smi": nvidia_smi()}
    check(props.multi_processor_count == HW["sm_count"],
          f"dryrun: the card has {props.multi_processor_count} SMs, HW says {HW['sm_count']}")
    check(props.total_memory >= HW["hbm_bytes"],
          f"dryrun: the card has {props.total_memory} bytes, HW says {HW['hbm_bytes']}")
    one_rank = AbstractMesh(("data", "model"), (1, 1))

    def both(cfg, shape, card_args):
        """Counts of the step on meta and, on ``card_args()``'s tensors,
        on the card, with the card's peak allocation over the step."""
        step, meta_args, _ = dryrun._build(cfg, shape, one_rank, quant_kv=False,
                                           microbatch=1)
        t0 = clock.now()
        meta = dryrun._run(step, meta_args)
        meta_s = clock.now() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        args = card_args()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = clock.now()
        card = dryrun._run(step, args)
        torch.cuda.synchronize()
        card_s = clock.now() - t0
        card_peak = torch.cuda.max_memory_allocated(dev) - base
        flops_by_op = meta.pop("flops_by_op")
        card.pop("flops_by_op")
        return step, args, {
            "meta": meta, "card": card, "flops_by_op": flops_by_op,
            "meta_count_s": meta_s, "card_count_s": card_s,
            "card_peak_allocated": card_peak,
            "card_peak_over_counted": card_peak / meta["peak_live_bytes"],
            "flops_equal": card["flops"] == meta["flops"],
            "bytes_equal": card["bytes"] == meta["bytes"],
            "bound": roofline_terms(flops=meta["flops"], hbm_bytes=meta["bytes"],
                                    wire_bytes=0, n_chips=1, hw=HW)}

    # (b) the train step.
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_prefix_tokens=0, enc_layers=0)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(1)

    def train_args():
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), device=dev,
                                  dtype=torch.int32, generator=gen)
                 for k in ("tokens", "labels")}
        return params, optim.init_state(params), batch

    step, args, train = both(cfg, ShapeCfg("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
                             train_args)
    train["step_ms"] = cuda_ms(torch, lambda: step(*args), 2)
    train["train_bounds"] = train_bounds(cfg, TRAIN_BATCH * TRAIN_SEQ, args[0])
    del step, args
    torch.cuda.empty_cache()
    lo, hi = DRYRUN_MEMORY_RATIO
    check(train["flops_equal"] and train["bytes_equal"],
          f"dryrun: {TRAIN_ARCH} train step counted {train['card']} on the card, "
          f"{train['meta']} on meta")
    check(lo <= train["card_peak_over_counted"] <= hi,
          f"dryrun: the card's peak {train['card_peak_allocated']} is "
          f"{train['card_peak_over_counted']} x the counted {train['meta']['peak_live_bytes']}")

    # (c) the decode step.
    cfg16 = get_config(LM_ARCH)
    model16 = get_model(cfg16)
    positions = LM_PROMPT + LM_GEN

    def decode_args():
        params = model16.init(torch.Generator(device=dev).manual_seed(0), dev)
        cache = model16.init_cache(LM_BATCH, positions, dtype=torch.bfloat16, device=dev)
        tokens = torch.randint(0, cfg16.vocab_size, (LM_BATCH, 1), device=dev,
                               dtype=torch.int32, generator=gen)
        return params, cache, {"tokens": tokens}

    step, args, decode = both(cfg16, ShapeCfg("decode", positions, LM_BATCH, "decode"),
                              decode_args)
    decode["decode_read_bytes"] = decode_read_bytes(cfg16, args[0], args[1], LM_BATCH)
    decode["step_ms"] = cuda_ms(torch, lambda: step(*args), 3)
    del step, args
    torch.cuda.empty_cache()
    check(decode["bytes_equal"], f"dryrun: {LM_ARCH} decode step counted "
                                 f"{decode['card']['bytes']} bytes on the card, "
                                 f"{decode['meta']['bytes']} on meta")
    check(decode["meta"]["bytes"] >= decode["decode_read_bytes"],
          f"dryrun: {LM_ARCH} decode counted {decode['meta']['bytes']} bytes, under "
          f"decode_read_bytes {decode['decode_read_bytes']}")

    launches = dict(ks.LAUNCHES)
    check(all(n == 0 for n in launches.values()),
          f"dryrun: the counted steps launched the port's kernels {launches}")
    return {"phase": "dryrun", "table": table,
            "train": {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, **train},
            "decode": {"arch": LM_ARCH, "batch": LM_BATCH, "positions": positions,
                       **decode},
            "launches": launches}


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def factors_close(np, got, ref, tol: float = 1e-3):
    """``(max abs difference, all within rtol = atol = tol)`` of two factor
    lists."""
    diff = max(float(np.max(np.abs(a - b))) for a, b in zip(got, ref))
    ok = all(np.allclose(a, b, rtol=tol, atol=tol) for a, b in zip(got, ref))
    return diff, ok


def b1e_factors(torch, np, shape, dev):
    """The seeded factors the B1e check runs on, on every rank."""
    rng = np.random.default_rng(23)
    return [torch.as_tensor(rng.standard_normal((I, RANK)).astype(np.float32), device=dev)
            for I in shape]


def dist_runs(torch, np, clock, ks, mesh, t, w):
    """One rank's part of the ``dist`` phase on the chicago stand-in ``t``:
    five distributed decompositions, then one window of the slab kernel's
    branch with a mesh (B1e) on this rank's packed shard, counted from 0,
    and each mode's B1e MTTKRP, kernel against plain, and times."""
    import dataclasses

    from repro_torch.core import als_device
    from repro_torch.core.distributed import (_collect_dist_data,
                                              collective_payload_bytes,
                                              cpd_als_distributed,
                                              make_distributed_plan,
                                              resolve_collectives,
                                              shard_slab_mode_data)
    from repro_torch.core.load_balance import Scheme
    from repro_torch.obs import trace

    dev = mesh.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = clock.now()
    plans = {"cp": make_distributed_plan(t, mesh),
             "nnz": make_distributed_plan(t, mesh, scheme=Scheme.NNZ_PARTITION),
             "masked": make_distributed_plan(t, mesh, method="masked", weights=w)}
    plan_s = clock.now() - t0
    # One sweep first: the communicator and the solver's handles are set
    # up at first use, not in a timed window.
    cpd_als_distributed(t, RANK, plan=plans["cp"], n_iters=1)
    runs = {}
    for name, method, plan, coll in (
            ("cp_psum", "cp", plans["cp"], "psum"),
            ("cp_gather", "cp", plans["cp"], "gather"),
            ("cp_nnz_partition", "cp", plans["nnz"], "psum"),
            ("nncp", "nncp", dataclasses.replace(plans["cp"], method="nncp"), "psum"),
            ("masked", "masked", plans["masked"], "psum")):
        stats0 = dict(mesh.stats)
        sync()
        with trace.capture() as tr:
            t0 = clock.now()
            res = cpd_als_distributed(t, RANK, plan=plan, n_iters=DIST_SWEEPS,
                                      check_every=DIST_CHECK, method=method,
                                      collective=coll)
            wall = clock.now() - t0
        windows = [r["dur_us"] / 1e3 for r in tr.records() if r["name"] == "dist.window"]
        colls = resolve_collectives(plan, coll)
        runs[name] = {
            "method": method, "collective": coll, "fits": res.fits,
            "factors": res.factors, "weights": res.weights, "iters": res.iters,
            "host_syncs": res.host_syncs, "wall_s": wall, "window_ms": windows,
            "median_window_ms": statistics.median(windows),
            "schemes": [m.scheme.value for m in plan.modes],
            "payload_bytes": collective_payload_bytes(plan, RANK, colls),
            **{f"{k}_per_sweep": (mesh.stats[k] - stats0[k]) / res.iters
               for k in ("collectives", "staged_copies", "wait_s")}}

    # B1e: one window of build_sweep_fn("slab", axis=mesh) from the seeded
    # init, the launches counted from 0 and read before any comparison.
    cp_plan = plans["cp"]
    md, meta = shard_slab_mode_data(cp_plan, RANK)
    _, fit_data = _collect_dist_data(cp_plan)
    shapes = tuple(int(s) for s in t.shape)
    solver = als_device.resolve_solver("auto", dev)
    window = als_device._build_sweep_block("slab", t.nmodes, RANK, shapes, meta, solver,
                                           DIST_CHECK, "cp", mesh)
    state = als_device.init_state(shapes, RANK, 0, device=dev)
    sync()
    reset_launches(ks)
    _, win_fits, win_ok = window(state, md, fit_data)
    sync()
    launches = ks.LAUNCHES["mttkrp_slab"]
    win_fits, win_ok = win_fits.tolist(), bool(win_ok)
    max_memory = torch.cuda.max_memory_allocated(dev) if cuda else None

    F = b1e_factors(torch, np, shapes, dev)
    ctx = als_device.make_sweep_context("slab", t.nmodes, RANK, shapes, meta, solver,
                                        axis=mesh)
    outs, modes = [], []
    r = mesh.rank
    for d, m in enumerate(cp_plan.modes):
        outs.append(ctx.one_mttkrp(d, md[d], [F], None)[0].cpu().numpy())
        idxp, valsp, lrowsp, rb_of, chunks, _ = md[d]
        nrb, br, tile, rblk = meta[d]
        kw = dict(num_row_blocks=nrb, block_rows=br, tile=tile)
        in_f = [F[v] for v in m.input_modes]
        kernel = functools.partial(ks.mttkrp_slab, idxp, valsp, lrowsp, rb_of, in_f,
                                   chunks=chunks, rank_block=rblk, **kw)
        k = kernel()
        plain = ks.mttkrp_slab_plain(idxp, valsp, lrowsp, rb_of, in_f, **kw)
        mag = ks.mttkrp_slab_plain(idxp, valsp.abs(), lrowsp, rb_of,
                                   [f.abs() for f in in_f], **kw)
        sync()
        entry = {"mode": d, "scheme": m.scheme.value, "shard_nnz": m.nnz_per_dev,
                 "nonzero_values": int(np.count_nonzero(m.vals[r])),
                 "slabs": int(rb_of.shape[0]),
                 "max_abs_err": float((k - plain).abs().max()),
                 "tol": 1e-5 * float(mag.max())}
        del plain, mag
        if cuda:
            partial = k[:m.num_rows]
            slots = int(rb_of.shape[0]) * tile
            entry.update(
                ms=cuda_ms(torch, kernel, TIMED_LAUNCHES),
                **pass_times(torch, kernel, TIMED_LAUNCHES),
                plain_ms=cuda_ms(torch, lambda: ks.mttkrp_slab_plain(
                    idxp, valsp, lrowsp, rb_of, in_f, **kw), 5),
                psum_ms=cuda_ms(torch, lambda: mesh.psum(partial), TIMED_LAUNCHES),
                **slab_bound(slots, len(in_f), chunks.numel(),
                             sum(shapes[v] for v in m.input_modes), nrb * br))
            # The shard's entries in relabeled rows; its zero-valued padding
            # (repeated coordinates) adds nothing and is left out.
            real = m.vals[r] != 0
            coords = np.zeros((int(real.sum()), t.nmodes), np.int64)
            coords[:, d] = m.rows[r][real]
            coords[:, list(m.input_modes)] = m.idx[r][real]
            lib, _ = library_mttkrp(torch, np, coords, shapes, d, m.vals[r][real], in_f)
            entry["library_ms"] = cuda_ms(torch, lib, 5)
            del lib
            torch.cuda.empty_cache()
        modes.append(entry)
    return {"rank": r, "size": mesh.size, "backend": mesh.backend, "device": str(dev),
            "plan_s": plan_s, "runs": runs,
            "b1e": {"launches": launches, "window_fits": win_fits, "window_ok": win_ok,
                    "mttkrp": outs, "modes": modes},
            "max_memory_allocated": max_memory, "mesh_stats": dict(mesh.stats)}


def pod_runs(torch, np, clock, ks, mesh, lanes, lane_w, cap):
    """One rank's part of the ``pod`` phase: ``BatchedEngine(mesh=...)`` on
    the first ``POD_REQUESTS`` requests of the uber bucket per method, each
    run's launches counted from 0; the same requests through the service
    (``service_run``); a zero iteration budget."""
    from repro_torch.core.coo import random_sparse
    from repro_torch.obs import trace
    from repro_torch.serve import BatchedEngine

    cuda = mesh.device.type == "cuda"
    out = {}
    for method in METHODS:
        eng = BatchedEngine(RANK, backend="slab", check_every=DIST_CHECK, mesh=mesh,
                            batch_quantum=POD_QUANTUM)
        t0 = clock.now()
        prep = eng.prepare_batch(lanes, n_iters=DIST_SWEEPS, tol=-1.0,
                                 seeds=list(range(len(lanes))), nnz_cap=cap,
                                 method=method,
                                 **({"weights": lane_w} if method == "masked" else {}))
        prep_s = clock.now() - t0
        reset_launches(ks)
        with trace.capture() as tr:
            if cuda:
                res, wall, dev_ms, kernel_ms = device_run(
                    torch, clock, lambda: eng.execute_prepared(prep))
            else:
                t0 = clock.now()
                res, dev_ms, kernel_ms = eng.execute_prepared(prep), None, None
                wall = clock.now() - t0
        launches = ks.LAUNCHES["mttkrp_slab_batched"]
        recs = {r["name"]: r["args"] for r in tr.records()
                if r["name"] in ("pod.window", "pod.dispatch")}
        window, dispatch = recs["pod.window"], recs["pod.dispatch"]
        out[method] = {
            "results": [{"fits": x.fits, "factors": x.factors, "weights": x.weights,
                         "iters": x.iters, "host_syncs": x.host_syncs,
                         "engine": x.engine} for x in res],
            "launches": launches, "prepare_s": prep_s, "execute_s": wall,
            "device_ms": dev_ms, "kernel_ms": kernel_ms,
            "device_ms_per_window": (None if dev_ms is None
                                     else dev_ms / window["windows_queued"]),
            "local_lanes": int(prep.carry[1].shape[0]), "window": window,
            "dispatch": {k: dispatch.get(k) for k in (
                "B", "devices", "B_per_device", "device_nnz", "lane_placement",
                "imbalance", "imbalance_contiguous", "device_nnz_contiguous")}}
    out["service"] = service_run(ks, clock, mesh, lanes, lane_w, cap)
    # A zero iteration budget (ROADMAP C3) on two small requests.
    small = [random_sparse(UBER_SHAPE, ZERO_BUDGET_NNZ, seed=50 + b) for b in range(2)]
    zero = BatchedEngine(RANK, backend="slab", check_every=DIST_CHECK, mesh=mesh
                         ).decompose_batch(small, n_iters=0, seeds=[0, 1])
    out["zero_budget"] = [{"iters": x.iters, "host_syncs": x.host_syncs,
                           "engine": x.engine, "fits": x.fits} for x in zero]
    return out


def service_run(ks, clock, mesh, lanes, lane_w, cap):
    """``DecompositionService(mesh=)`` on the pod's requests under each of
    ``SERVICE_METHODS``, in one service: one bucket per method whose cap
    is the pod engine's, one flush each at the pod's batch quantum, one
    drain.  Rank 0 submits and drains; another rank serves in
    ``drain()``."""
    from repro_torch.serve import BucketPolicy, DecompositionService

    svc = DecompositionService(RANK, backend="slab", check_every=DIST_CHECK, mesh=mesh,
                               batch_quantum=POD_QUANTUM, max_batch=LANES,
                               policy=BucketPolicy(quantum=cap, min_cap=1),
                               clock=lambda: 0.0)
    reset_launches(ks)
    t0 = clock.now()
    results, served = None, None
    if svc.controller:
        futs = {m: [svc.submit(x, n_iters=DIST_SWEEPS, tol=-1.0, seed=b, method=m,
                               **({"weights": lane_w[b]} if m == "masked" else {}))
                    for b, x in enumerate(lanes)] for m in SERVICE_METHODS}
        svc.drain()
        results = {m: [{"fits": r.fits, "factors": r.factors, "weights": r.weights,
                        "iters": r.iters, "host_syncs": r.host_syncs, "engine": r.engine}
                       for r in (f.result() for f in fs)] for m, fs in futs.items()}
    else:
        served = svc.drain()
    return {"results": results, "served": served, "wall_s": clock.now() - t0,
            "launches": ks.LAUNCHES["mttkrp_slab_batched"],
            "batches": svc.snapshot()["batches"], "mesh_size": mesh.size}


def cross_pod_check(torch, dev, shapes):
    """One compressed and one plain ``cross_pod_mean`` of seeded per-rank
    gradients of ``shapes`` over a 'pod' mesh of every rank: the largest
    error of each against the exact mean, the int8 bound (the ranks' mean
    of half a quantization step), and whether the plain mean is bitwise
    psum / kappa."""
    from repro_torch import optim
    from repro_torch.launch import make_mesh

    pod = make_mesh((torch.distributed.get_world_size(),), ("pod",), device=dev)
    gen = torch.Generator(device=dev).manual_seed(100 + pod.rank)
    g = {k: torch.randn(s, generator=gen, device=dev) for k, s in shapes.items()}
    err = {k: torch.zeros_like(v) for k, v in g.items()}
    mean, new_err = optim.cross_pod_mean(g, err, pod)
    plain, _ = optim.cross_pod_mean(g, err, pod, compress=False)
    out = {}
    for k, v in g.items():
        exact = pod.psum(v) / pod.size
        half_step = optim.quantize(v)[1].reshape(()) * 0.5
        out[k] = {"max_abs_err": float((mean[k] - exact).abs().max()),
                  "bound": float(pod.psum(half_step)) / pod.size,
                  "residual_max": float(new_err[k].abs().max()),
                  "plain_bitwise_psum_over_kappa": bool(torch.equal(plain[k], exact))}
    return out


def rank_work(mesh, cfg):
    """A spawned rank of the kappa = 2 mesh: the parent's chicago stand-in
    and uber requests, loaded from ``cfg["inputs"]``, then its part of
    ``dist`` and ``pod`` (the batch mesh is the same process group) and a
    ``cross_pod_mean`` of the embed phase's gradient shapes."""
    import numpy as np
    import torch

    from repro_torch.core.coo import SparseTensor
    from repro_torch.kernels import mttkrp_slab as ks
    from repro_torch.launch import make_batch_mesh
    from repro_torch.obs import clock

    t0 = clock.now()
    with np.load(cfg["inputs"]) as z:
        t = SparseTensor(z["t_indices"], z["t_values"], tuple(int(s) for s in z["t_shape"]))
        w = z["w"]
        lanes = [SparseTensor(z[f"lane{b}_indices"], z[f"lane{b}_values"], UBER_SHAPE)
                 for b in range(cfg["requests"])]
        lane_w = [z[f"lane{b}_w"] for b in range(cfg["requests"])]
    load_s = clock.now() - t0
    dist = dist_runs(torch, np, clock, ks, mesh, t, w)
    del t, w
    pod = pod_runs(torch, np, clock, ks, make_batch_mesh(device=cfg["device"]),
                   lanes, lane_w, cfg["cap"])
    return {"load_s": load_s, "dist": dist, "pod": pod,
            "cross_pod": cross_pod_check(torch, mesh.device, cfg["grad_shapes"])}


def dist_pod_phases(torch, np, clock, ks, t, w, refs, lanes, lane_w, cap, batched_res, cfg):
    """The ``dist`` and ``pod`` phases: kappa = 1 over NCCL in this process,
    then kappa = 2 over gloo on spawned ranks sharing the one card, each
    held against the single-device results ``refs`` (cp, nncp, masked on
    the chicago stand-in) and ``batched_res`` (the batched phase)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.core.mttkrp import make_plan, mttkrp
    from repro_torch.launch import init_ranks, make_batch_mesh, spawn_ranks

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    t0 = clock.now()
    mesh = init_ranks(0, 1, f"file://{tempfile.mkdtemp(dir=build_dir)}/rendezvous",
                      device=cfg["device"])
    try:
        one = {"dist": dist_runs(torch, np, clock, ks, mesh, t, w),
               "pod": pod_runs(torch, np, clock, ks, make_batch_mesh(1, device=cfg["device"]),
                               lanes[:cfg["requests"]], lane_w[:cfg["requests"]], cap)}
    finally:
        dist.destroy_process_group()
    k1_s = clock.now() - t0
    t0 = clock.now()
    # The ranks load this process's inputs rather than generate their own.
    workdir = Path(tempfile.mkdtemp(dir=build_dir))
    n = cfg["requests"]
    np.savez(workdir / "inputs.npz", t_indices=t.indices, t_values=t.values,
             t_shape=np.asarray(t.shape), w=w,
             **{f"lane{b}_{k}": v for b in range(n) for k, v in (
                 ("indices", lanes[b].indices), ("values", lanes[b].values),
                 ("w", lane_w[b]))})
    cfg = {**cfg, "inputs": str(workdir / "inputs.npz")}
    try:
        two = spawn_ranks(rank_work, 2, (cfg,), timeout=RANK_TIMEOUT_S, device=cfg["device"],
                          workdir=workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    k2_s = clock.now() - t0
    ranks = {1: [one], 2: two}

    # -- dist gates ------------------------------------------------------------
    single_plan = make_plan(t, 1, device=cfg["device"])
    F = b1e_factors(torch, np, t.shape, torch.device(cfg["device"]))
    single = [mttkrp(single_plan, F, d, backend="slab").cpu().numpy()
              for d in range(t.nmodes)]
    single_tol = [1e-5 * abs_mttkrp_max(ks, single_plan, F, d) for d in range(t.nmodes)]
    ref_of = {"cp_psum": refs["cp"], "cp_gather": refs["cp"], "cp_nnz_partition": refs["cp"],
              "nncp": refs["nncp"], "masked": refs["masked"]}
    dist_out = {}
    for kappa, per_rank in ranks.items():
        rows = {"backend": per_rank[0]["dist"]["backend"], "runs": {}, "ranks": []}
        for name, ref in ref_of.items():
            got = [x["dist"]["runs"][name] for x in per_rank]
            fit_gap_ = fit_gap(np, got[0]["fits"], ref.fits)
            fdiff, fok = factors_close(np, got[0]["factors"], ref.factors)
            check(fit_gap_ <= 1e-4 and fok,
                  f"dist kappa {kappa} {name}: fits off by {fit_gap_}, factors by {fdiff}")
            check(all(g["host_syncs"] == 3 and g["iters"] == DIST_SWEEPS for g in got),
                  f"dist kappa {kappa} {name}: host_syncs {[g['host_syncs'] for g in got]}")
            same = all(g["fits"] == got[0]["fits"]
                       and all(np.array_equal(a, b) for a, b in zip(g["factors"], got[0]["factors"]))
                       for g in got)
            check(same, f"dist kappa {kappa} {name}: factors differ across ranks")
            rows["runs"][name] = {
                "schemes": got[0]["schemes"], "fits": got[0]["fits"],
                "fit_gap_vs_single": fit_gap_, "factor_diff_vs_single": fdiff,
                "host_syncs": got[0]["host_syncs"], "ranks_bitwise": same,
                "payload_bytes_per_sweep": got[0]["payload_bytes"],
                "per_rank": [{k: g[k] for k in (
                    "wall_s", "median_window_ms", "window_ms", "collectives_per_sweep",
                    "staged_copies_per_sweep", "wait_s_per_sweep")} for g in got]}
        psum, gather = (per_rank[0]["dist"]["runs"][n] for n in ("cp_psum", "cp_gather"))
        g_fit = fit_gap(np, gather["fits"], psum["fits"])
        g_diff, g_ok = factors_close(np, gather["factors"], psum["factors"])
        check(g_fit <= 1e-4 and g_ok, f"dist kappa {kappa}: gather vs psum {g_fit} {g_diff}")
        if kappa > 1:
            check(gather["payload_bytes"] < psum["payload_bytes"],
                  f"dist kappa {kappa}: gather payload {gather['payload_bytes']} not "
                  f"below psum's {psum['payload_bytes']}")
            check(per_rank[0]["dist"]["runs"]["cp_nnz_partition"]["schemes"]
                  == [2] * t.nmodes, "dist: the forced scheme 2 did not hold")
        for x in per_rank:
            b = x["dist"]["b1e"]
            check(b["launches"] == DIST_CHECK * t.nmodes,
                  f"dist kappa {kappa} rank {x['dist']['rank']}: B1e window launched "
                  f"the kernel {b['launches']} times")
            check(b["window_ok"], "dist: B1e window flagged a solve")
            w_gap = fit_gap(np, b["window_fits"], refs["cp"].fits[:DIST_CHECK])
            check(w_gap <= 1e-5, f"dist kappa {kappa}: B1e window fits off by {w_gap}")
            errs = []
            for d, (got_m, ref_m, tol) in enumerate(zip(b["mttkrp"], single, single_tol)):
                err = float(np.max(np.abs(got_m - ref_m)))
                check(err <= tol, f"dist kappa {kappa} B1e mode {d}: {err} > {tol}")
                m = b["modes"][d]
                check(m["max_abs_err"] <= m["tol"], f"dist kappa {kappa} B1e mode {d}: "
                      f"kernel vs plain {m['max_abs_err']} > {m['tol']}")
                errs.append(err)
            rows["ranks"].append({
                "rank": x["dist"]["rank"], "plan_s": x["dist"]["plan_s"],
                "b1e_launches": b["launches"], "b1e_window_fit_gap": w_gap,
                "b1e_err_vs_single": errs, "b1e_tol_vs_single": single_tol,
                "b1e_modes": b["modes"],
                "max_memory_allocated": x["dist"]["max_memory_allocated"],
                "mesh_stats": x["dist"]["mesh_stats"]})
        dist_out[f"kappa{kappa}"] = rows

    # -- pod gates ------------------------------------------------------------------
    pod_out = {}
    for kappa, per_rank in ranks.items():
        rows = {}
        for method in METHODS:
            got = [x["pod"][method] for x in per_rank]
            res0 = got[0]["results"]
            check(len(res0) == cfg["requests"], f"pod kappa {kappa} {method}: "
                                                f"{len(res0)} results")
            gaps, bitwise = [], True
            for b, r in enumerate(res0):
                ref = batched_res[method][b]
                gaps.append(fit_gap(np, r["fits"], ref.fits))
                bitwise &= (r["fits"] == ref.fits and all(
                    np.array_equal(a, c) for a, c in zip(r["factors"], ref.factors)))
            check(max(gaps) <= 1e-5, f"pod kappa {kappa} {method}: lanes off by {gaps}")
            for g in got:
                check(all(r["host_syncs"] == 1 and r["engine"] == "pod" for r in g["results"]),
                      f"pod kappa {kappa} {method}: host_syncs / engine")
                check(g["window"]["windows"] == -(-DIST_SWEEPS // DIST_CHECK),
                      f"pod kappa {kappa} {method}: windows {g['window']}")
                check(g["launches"] == DIST_SWEEPS * len(UBER_SHAPE),
                      f"pod kappa {kappa} {method}: {g['launches']} batched launches")
            same = all(all(a["fits"] == c["fits"] and all(
                np.array_equal(x, y) for x, y in zip(a["factors"], c["factors"]))
                for a, c in zip(g["results"], res0)) for g in got)
            check(same, f"pod kappa {kappa} {method}: ranks disagree")
            if method in SERVICE_METHODS:
                svc_res = per_rank[0]["pod"]["service"]["results"][method]
                check(len(svc_res) == cfg["requests"] and all(
                    a["fits"] == b["fits"] and a["iters"] == b["iters"]
                    and a["host_syncs"] == b["host_syncs"] == 1 and a["engine"] == "pod"
                    and np.array_equal(a["weights"], b["weights"])
                    and all(np.array_equal(x, y) for x, y in zip(a["factors"], b["factors"]))
                    for a, b in zip(svc_res, res0)),
                    f"pod kappa {kappa} {method}: the service differs from the pod engine")
            rows[method] = {
                "max_fit_gap_vs_batched": max(gaps), "bitwise_vs_batched": bitwise,
                "ranks_bitwise": same, "host_syncs": res0[0]["host_syncs"],
                "per_rank": [{k: g[k] for k in (
                    "launches", "prepare_s", "execute_s", "device_ms", "kernel_ms",
                    "device_ms_per_window", "local_lanes", "window", "dispatch")}
                    for g in got]}
        # One flush per method, every rank launching each flush's sweeps.
        runs = [x["pod"]["service"] for x in per_rank]
        flushes = len(SERVICE_METHODS)
        check(all(r["launches"] == flushes * DIST_SWEEPS * len(UBER_SHAPE) for r in runs)
              and runs[0]["batches"] == flushes
              and all(r["served"] == flushes for r in runs[1:]),
              f"pod kappa {kappa}: service launches / flushes "
              f"{[(r['launches'], r['batches'], r['served']) for r in runs]}")
        rows["service"] = {
            "methods": list(SERVICE_METHODS), "bitwise_vs_pod_engine": True,
            "per_rank": [{k: r[k] for k in ("wall_s", "launches", "batches", "served")}
                         for r in runs]}
        for x in per_rank:
            check(all(z["iters"] == 0 and z["host_syncs"] == 1 and z["engine"] == "pod"
                      and z["fits"] == [] for z in x["pod"]["zero_budget"]),
                  f"pod kappa {kappa}: zero budget {x['pod']['zero_budget']}")
        rows["zero_budget"] = per_rank[0]["pod"]["zero_budget"]
        pod_out[f"kappa{kappa}"] = rows
    for x in two:
        for k, c in x["cross_pod"].items():
            check(c["max_abs_err"] <= c["bound"] * (1 + 1e-3) and c["plain_bitwise_psum_over_kappa"],
                  f"cross_pod_mean {k}: {c}")
    pod_out["cross_pod_mean"] = [x["cross_pod"] for x in two]
    return ({"phase": "dist", "tensor": "chicago", "shape": list(t.shape), "nnz": t.nnz,
             "rank": RANK, "sweeps": DIST_SWEEPS, "check_every": DIST_CHECK,
             "kappa1_s": k1_s, "kappa2_s": k2_s,
             "kappa2_load_s": [x["load_s"] for x in two], **dist_out},
            {"phase": "pod", "requests": cfg["requests"], "batch_quantum": POD_QUANTUM,
             "shape": list(UBER_SHAPE), "nnz_cap": cap, "rank": RANK,
             "sweeps": DIST_SWEEPS, "check_every": DIST_CHECK, **pod_out})


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
    JSONL.unlink(missing_ok=True)

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
    captures = ks.CAPTURES["mttkrp_slab"]
    # The plan's first call runs its 10 sweeps eagerly, then captures the
    # sweep's graphs (one kernel call per mode, counted as a capture) and
    # replays them once (one launch per mode).
    check(launches == 40 + t.nmodes and captures == t.nmodes,
          f"main path launched the kernel {launches} times, not 40 + "
          f"{t.nmodes}, and counted {captures} captures, not {t.nmodes}")
    check(res.graph_sweeps == 0, f"main path replayed {res.graph_sweeps} sweeps")
    check(res.host_syncs == 3, f"host_syncs {res.host_syncs} != 3")
    check(res.iters == 10 and len(res.fits) == 10, "main path did not run 10 sweeps")
    check(all(np.isfinite(F).all() and F.shape == (I, RANK)
              for F, I in zip(res.factors, t.shape)), "bad factors")
    seg = cpd_als(t, RANK, plan=plan, backend="segment", n_iters=10,
                  check_every=5, device="cuda")
    gap = float(np.max(np.abs(np.array(res.fits) - np.array(seg.fits))))
    check(gap <= 1e-5, f"slab fits differ from segment fits by {gap}")
    # A second call on the plan from the same start replays the graphs.
    reset_launches(ks)
    rep = cpd_als(t, RANK, plan=plan, backend="slab", n_iters=10,
                  check_every=5, device="cuda")
    replay = check_replay(np, ks, "main path", rep, res, seg,
                          ks.LAUNCHES["mttkrp_slab"])

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
    emit({"phase": "main_path", "launches": launches, "captures": captures,
          "replay": replay, "host_syncs": res.host_syncs,
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
    nn_captures = ks.CAPTURES["mttkrp_slab"]
    check(nn_launches["mttkrp_slab"] == 40 + t.nmodes and nn_captures == t.nmodes,
          f"nncp launched the kernel {nn_launches['mttkrp_slab']} times, not "
          f"40 + {t.nmodes}, and counted {nn_captures} captures, not {t.nmodes}")
    check(nn.graph_sweeps == 0, f"nncp replayed {nn.graph_sweeps} sweeps")
    check(nn.host_syncs == 3, f"nncp host_syncs {nn.host_syncs} != 3")
    check(all(bool((F >= 0).all()) for F in nn.factors), "nncp factor < 0")
    check(largest_drop(nn.fits) <= 1e-6, f"nncp fit fell: {nn.fits}")
    nn_seg = cpd_als(t, RANK, backend="segment", method="nncp", **mkw)
    nn_gap = fit_gap(np, nn.fits, nn_seg.fits)
    check(nn_gap <= 1e-5, f"nncp slab fits differ from segment by {nn_gap}")
    reset_launches(ks)
    nn_rep = cpd_als(t, RANK, backend="slab", method="nncp", **mkw)
    nn_replay = check_replay(np, ks, "nncp", nn_rep, nn, nn_seg,
                             ks.LAUNCHES["mttkrp_slab"])

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
          "nncp": {"launches": nn_launches, "captures": nn_captures,
                   "replay": nn_replay, "host_syncs": nn.host_syncs,
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
    fit_fn = als_device._build_folded_fit(RANK)
    one_sweep = als_device._build_sweep_block("slab", t.nmodes, RANK, shapes,
                                              meta, "cho", 1)
    st = state_from_reference(*als_device.init_state_host(shapes, RANK, 0), device=dev)
    mttkrp_ms = cuda_ms(torch, lambda: [one(d, mode_data[d], st[0])
                                        for d in range(t.nmodes)], 5)
    m_last = one(t.nmodes - 1, mode_data[-1], st[0])
    fit_ms = cuda_ms(torch, lambda: fit_fn(m_last, st[0], st[1], st[2], fit_data), 5)
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
    del Ms, m_last

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

    # -- embed: the factorized embedding of qwen1.5-4b, its gradient as B1f --------
    t0 = clock.now()
    embed_out = embed_phase(torch, np, clock, ks, dev)
    embed_out["phase_s"] = clock.now() - t0
    emit(embed_out)
    torch.cuda.empty_cache()

    # -- lm: the LM serving path, qwen1.5-4b at full width ------------------------
    t0 = clock.now()
    lm_out = lm_phase(torch, np, clock, ks, dev)
    lm_out["phase_s"] = clock.now() - t0
    emit(lm_out)
    torch.cuda.empty_cache()

    # -- the other LM families at full width through the same launcher ------------
    for name, arch, B, P, G in FAMILY_RUNS:
        t0 = clock.now()
        out = family_phase(torch, np, clock, ks, dev, name, arch, B, P, G)
        out["phase_s"] = clock.now() - t0
        out["nvidia_smi"] = smi
        emit(out)
        torch.cuda.empty_cache()

    # -- train: LM training through launch.train, internvl2-1b and granite ------
    t0 = clock.now()
    train_out = train_phase(torch, np, clock, ks, dev)
    train_out["phase_s"] = clock.now() - t0
    train_out["nvidia_smi"] = smi
    emit(train_out)
    torch.cuda.empty_cache()

    # -- dryrun: the dry run's H100 table and step counts held to the card --------
    t0 = clock.now()
    dryrun_out = dryrun_phase(torch, np, clock, ks, dev)
    dryrun_out["phase_s"] = clock.now() - t0
    emit(dryrun_out)
    torch.cuda.empty_cache()

    # -- dist and pod: the mesh paths, kappa = 1 (NCCL) and 2 (gloo, one card) ---
    t0 = clock.now()
    grad_shapes = {"dA": (embed_out["factor_vocab"][0], EMBED_RANK),
                   "dB": (embed_out["factor_vocab"][1], EMBED_RANK)}
    cfg = {"device": "cuda", "requests": POD_REQUESTS, "cap": cap,
           "grad_shapes": grad_shapes}
    dist_out, pod_out = dist_pod_phases(
        torch, np, clock, ks, t, w, {"cp": res, "nncp": nn, "masked": mk}, lanes, lane_w,
        cap, batched_res, cfg)
    dist_out["phase_s"] = pod_out["phase_s"] = clock.now() - t0
    emit(dist_out)
    emit(pod_out)

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
        kernel_entry("mttkrp_slab", per_mode, launches + replay["launches"],
                     max(m["max_abs_err"] for m in modes),
                     {"main_path": launches + replay["launches"],
                      "methods": nn_launches["mttkrp_slab"] + nn_replay["launches"],
                      "stream": new_phases["stream"]["launches"],
                      "plan": plan_out["launches"],
                      "embed": embed_out["launches"]["mttkrp_slab"],
                      "train": train_out["launches"]["mttkrp_slab"],
                      "dryrun": dryrun_out["launches"]["mttkrp_slab"],
                      "dist": dist_out["kappa1"]["ranks"][0]["b1e_launches"],
                      "dist_kappa2_ranks": [x["b1e_launches"]
                                            for x in dist_out["kappa2"]["ranks"]]}),
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
                      + service["runner_stream"]["launches"],
                      "pod": sum(pod_out["kappa1"][m]["per_rank"][0]["launches"]
                                 for m in METHODS),
                      "pod_kappa2_ranks": [
                          sum(pod_out["kappa2"][m]["per_rank"][r]["launches"]
                              for m in METHODS) for r in range(2)],
                      "pod_service": pod_out["kappa1"]["service"]["per_rank"][0]["launches"],
                      "pod_service_kappa2_ranks": [
                          r["launches"] for r in pod_out["kappa2"]["service"]["per_rank"]]}),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
