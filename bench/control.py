"""Readings the limits of ``correct`` are set from, at a cell's own size.

    python3 bench/control.py --workload <cell> --seeds 12 --control-seeds 3 \
        --first-seed <n> [--out <file.json>]

For each seed, one process makes the cell's stand-in tensor and plan,
warms up, makes as many calls as a run checks, and holds each to the
float64 reference: the program's readings.  For the first
``--control-seeds`` seeds it also puts the reference computed in TF32 (the
nearest precision below the configuration's float32 with TF32 off) in
the program's place: the control's readings.  A limit lies above the
largest program reading and below the smallest control reading.  Not a
part of any benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, control: bool, device) -> dict:
    import torch

    from bench.harness import check
    from bench.harness.cell import Run, free_program, setup

    cfg, tr = cell.config, cell.traffic
    run = Run(cell=cell, seed=seed, seconds=0.0, trace=False, device=device,
              shape=tuple(cfg["shape"]), nnz=cfg["nnz"], rank=cfg["rank"])
    indices, values, client = setup(run, time.perf_counter())
    calls, window_s = client.closed_loop(float("inf"),
                                         max_calls=tr["checked_calls"])
    del client
    free_program(run)
    ref = check.load_reference(cfg["reference"], cell.bench_dir)
    out = {"seed": seed, "setup_s": run.spans["setup"], "calls_s": window_s,
           "program": [], "control": [], "reference_s": []}
    for c in calls:
        t0 = time.perf_counter()
        r = check.reference_run(ref, indices, values, cfg["shape"], c.init,
                                tr["n_iters"], device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["reference_s"].append(time.perf_counter() - t0)
        out["program"].append(
            check.gaps((c.result.factors, c.result.weights, c.result.fits), r)
            if c.ok else {"factor_gap": "inf", "fit_gap": "inf"})
        out.setdefault("final_fit", []).append(float(r[2][-1]))
        out.setdefault("max_weight", []).append(float(r[1].max()))
        if control:
            q = check.reference_run(ref, indices, values, cfg["shape"],
                                    c.init, tr["n_iters"], device,
                                    precision="tf32")
            out["control"].append(check.gaps(
                ([F.cpu().numpy() for F in q[0]], q[1].cpu().numpy(),
                 q[2].cpu().numpy()), r))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from bench.harness import guard, spec

    guard.require_cards(1)
    cell = spec.find_cell(args.workload, spec.load_benchmark(ROOT))
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for i in range(args.seeds):
        row = readings(cell, args.first_seed + i, i < args.control_seeds, dev)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload,
               "device": torch.cuda.get_device_name(dev)}
    for side in ("program", "control"):
        for k in ("factor_gap", "fit_gap"):
            vals = [float(g[k]) for r in rows for g in r[side]]
            if vals:
                summary[f"{side}_{k}"] = [min(vals), max(vals)]
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"summary": summary,
                                              "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
