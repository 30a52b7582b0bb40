"""Time each part of the slab kernel's design alone, on one NVIDIA GPU.

    PYTHONPATH=src python -m repro_torch.kernels.slab_ablation   (repository root)

On the chicago stand-in at rank 16 (the main path's packings), every
mode's value-baked launch is timed by CUDA events as built, and with one
part of the design taken back at a time:

  narrow     one rank column per thread (16 walkers of 16 threads each)
             in place of four (64 walkers of 4);
  unstaged   every factor gathered from device memory, none staged in
             shared memory;
  one_group  pass two as one group per row block: each row block's chunk
             partials summed serially by one set of blocks, as the first
             version of the kernel did;
  direct     the slot stream read by each walker with 16-byte loads from
             device memory in place of the cp.async ring;
  carveout_shared  the SM's L1/shared split forced to the most shared
             memory, where the built kernel leaves CUDA's default;

and with the sizes the design fixes set otherwise: chunks of 8, 32 or
64 slabs in place of 16 (``chunks8`` ...), ring stages of 4,
16 or 32 slots per walker in place of 8 (``stage4`` ...), a ring of 3 or
4 buffers in place of 2 (``ring3``, ``ring4``), pass one held to 48 or
40 registers or left free of the 64-register limit that blocks of 1024
threads impose (``regs48``, ``regs40``, ``regs_free``).  The variants
that change the source (every one but the chunk and stage sizes and
``narrow``, ``unstaged`` and ``one_group``) are
built from a patched copy of it beside the library, in parallel.

The variants run in turns, ``ROUNDS`` times; each result is the median
over the rounds of the device time per call over ``LAUNCHES`` calls
queued back to back.  Every variant's output is held to 1e-5 of the
absolute sum against the built kernel's.  Each line also gives every
variant's pass-one blocks resident per SM.
Prints one JSON line per mode, then the card's name and power limit.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from . import build
from . import mttkrp_slab as ks

RANK = 16
ROUNDS = 3
LAUNCHES = 21

# Copies of the source with one part replaced, as (old, new) text pairs.
_RING = "constexpr int kRingStages = 2;"
_PATCHES = {
    # The slot stream read with 16-byte loads from device memory in place
    # of the cp.async ring (its copies no longer issued).
    "direct": (
        ("ix[w] = *reinterpret_cast<const int4*>(buf + w * ring_stream + u0);",
         "ix[w] = __ldg(reinterpret_cast<const int4*>(idx + w * a.slots + js + u0));"),
        ("*reinterpret_cast<const float4*>(buf + W * ring_stream + u0);",
         "__ldg(reinterpret_cast<const float4*>(vals + js + u0));"),
        ("*reinterpret_cast<const int4*>(buf + (W + 1) * ring_stream + u0);",
         "__ldg(reinterpret_cast<const int4*>(lrows + js + u0));"),
        ("#pragma unroll\n  for (int s = 0; s < kRingStages - 1; ++s) prefetch(s);\n", "\n"),
        ("    prefetch(s + kRingStages - 1);\n", "\n"),
    ),
    "ring3": ((_RING, "constexpr int kRingStages = 3;"),),
    "ring4": ((_RING, "constexpr int kRingStages = 4;"),),
    # Other register limits for pass one (the built kernel allows 64, for
    # blocks of up to 1024 threads).
    "regs48": (("__launch_bounds__(1024)", "__launch_bounds__(256, 5)"),),
    "regs40": (("__launch_bounds__(1024)", "__launch_bounds__(256, 6)"),),
    "regs_free": (("__launch_bounds__(1024)", "__launch_bounds__(256)"),),
    # The SM's L1/shared split forced to the most shared memory.
    "carveout_shared": (
        ("  *err = k ? cudaSuccess : cudaErrorInvalidValue;\n",
         "  *err = k ? cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,\n"
         "                                  cudaSharedmemCarveoutMaxShared)\n"
         "           : cudaErrorInvalidValue;\n"
         "  if (*err != cudaSuccess) return nullptr;\n"),),
}
RING_DEPTH = {"ring3": 3, "ring4": 4}


def patched_library(name: str):
    """The kernel built from a copy of its source with patch ``name``."""
    text = (build.CSRC / "mttkrp_slab.cu").read_text()
    for old, new in _PATCHES[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"ablation patch no longer matches the source: {old!r}")
        text = text.replace(old, new)
    src = build.BUILD_DIR / "ablation" / f"mttkrp_slab_{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    return build.compile_source(src)


def cuda_ms(fn, calls: int) -> float:
    """Device time per call over ``calls`` calls queued back to back (the
    host queues a call faster than the card runs it, so the queue stays
    full and host time does not enter)."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def one_group_per_row_block(chunks: ks.SlabChunks) -> ks.SlabChunks:
    nrb = int(chunks.rb_chunk_ptr.numel()) - 1
    return dataclasses.replace(
        chunks, group_chunk=chunks.rb_chunk_ptr,
        rb_group_ptr=torch.arange(nrb + 1, dtype=torch.int32,
                                  device=chunks.rb_chunk_ptr.device))


def main() -> int:
    if not torch.cuda.is_available():
        print("slab_ablation needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from ..core.coo import frostt_like
    from ..core.mttkrp import make_plan

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    with concurrent.futures.ThreadPoolExecutor(len(_PATCHES)) as pool:
        paths = dict(zip(_PATCHES, pool.map(patched_library, _PATCHES)))
    libs = {"built": build.load_library(),
            **{name: build.bind_library(path) for name, path in paths.items()}}
    paths["built"] = build.library_path(build.CSRC / "mttkrp_slab.cu")
    print(json.dumps({"ptxas": {  # the float32 instance chicago's modes launch
        name: [ln for ln in build.ptxas_summary(path.with_suffix(".log").read_text())
               if ln.startswith("chunk_tiles_kernel<float,W=3,V=4>")]
        for name, path in paths.items()}}), flush=True)
    t = frostt_like("chicago", scale=1.0)
    plan = make_plan(t, kappa=1, device=dev)
    rng = np.random.default_rng(7)
    F = [torch.as_tensor(rng.standard_normal((I, RANK)).astype(np.float32), device=dev)
         for I in t.shape]
    limit = ks.shared_memory_per_block(dev)
    for d in range(t.nmodes):
        idxp, valsp, lrowsp, rb_of, chunks, _ = plan.device_packed(d)
        p = plan.packed(d)
        in_f = [F[w] for w in plan.layouts[d].input_modes()]
        rows = [int(f.shape[0]) for f in in_f]
        cfg = ks.launch_config(RANK, RANK, p.block_rows, rows, smem_limit=limit)
        variants = {
            "built": ("built", cfg, chunks),
            "narrow": ("built", ks.launch_config(RANK, RANK, p.block_rows, rows,
                                                 aligned=False, smem_limit=limit),
                       chunks),
            "unstaged": ("built", dataclasses.replace(cfg, staged_mask=0), chunks),
            "one_group": ("built", cfg, one_group_per_row_block(chunks)),
            **{name: (name, cfg, chunks) for name in _PATCHES},
            # The constants the design fixes: chunk size and ring stage.
            "chunks8": ("built", cfg, ks.slab_chunks(p.rb_of, p.num_row_blocks, dev, 8)),
            "chunks32": ("built", cfg, ks.slab_chunks(p.rb_of, p.num_row_blocks, dev, 32)),
            "chunks64": ("built", cfg, ks.slab_chunks(p.rb_of, p.num_row_blocks, dev, 64)),
            "stage4": ("built", dataclasses.replace(cfg, stage_slots=4), chunks),
            "stage16": ("built", dataclasses.replace(cfg, stage_slots=16), chunks),
            "stage32": ("built", dataclasses.replace(cfg, stage_slots=32), chunks),
        }
        kw = dict(batch=None, num_row_blocks=p.num_row_blocks, block_rows=p.block_rows,
                  tile=p.tile, rank_block=RANK, slots=p.num_slabs * p.tile)

        def call(name):
            lib, c, ch = variants[name]
            return ks.run_kernel(libs[lib], c, idxp, valsp, lrowsp, in_f, ch, **kw)

        ref = call("built")
        mag = ks.mttkrp_slab_plain(idxp, valsp.abs(), lrowsp, rb_of,
                                   [f.abs() for f in in_f],
                                   num_row_blocks=p.num_row_blocks,
                                   block_rows=p.block_rows, tile=p.tile)
        tol = 1e-5 * float(mag.max())
        errs = {name: float((call(name) - ref).abs().max()) for name in variants}
        if max(errs.values()) > tol:
            raise RuntimeError(f"mode {d}: a variant disagrees: {errs} > {tol}")
        times = {name: [] for name in variants}
        for _ in range(ROUNDS):
            for name in variants:
                times[name].append(cuda_ms(lambda: call(name), LAUNCHES))
        occupancy = {}
        for name, (lib, c, _) in variants.items():
            # smem_bytes with this variant's ring, plus its staged factors
            stage = 4 * (len(rows) + 2) * c.walkers
            ring = RING_DEPTH.get(name, ks.RING_STAGES) * stage * c.stage_slots
            smem = (ks.smem_bytes(p.block_rows, RANK, c.cols, len(rows))
                    - ks.RING_STAGES * stage * ks.stage_slots_for(c.walkers) + ring
                    + sum(r * RANK * 4 for w, r in enumerate(rows)
                          if c.staged_mask >> w & 1))
            occupancy[name] = ks.blocks_per_sm(libs[lib], dataclasses.replace(
                c, smem=smem), len(rows), False, dev)
        print(json.dumps({
            "mode": d, "rows": rows, "staged_mask": cfg.staged_mask,
            "blocks_per_sm": occupancy,
            "chunks": chunks.num_chunks, "row_blocks": p.num_row_blocks,
            "ms": {name: statistics.median(v) for name, v in times.items()},
            "rounds_ms": times, "max_abs_err_vs_built": errs, "tol": tol}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
