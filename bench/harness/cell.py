"""One run of one cell: set-up, the measured window, the traced stretch,
the per-layer readers, the check against the reference, the result line.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import subprocess
import sys
import time

import torch

from . import check, counts, data, devtime, guard
from . import traffic as traffic_mod
from .spec import Cell, metric_reader


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``bench/metrics/<name>.py``)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    shape: tuple
    nnz: int
    rank: int
    program: object = None          # the program's modules, by name
    tensor: object = None           # the program's SparseTensor
    plan: object = None
    spans: dict = dataclasses.field(default_factory=dict)   # host seconds
    calls: list = dataclasses.field(default_factory=list)   # window calls
    window_s: float = 0.0           # the untraced part of the window
    window_sweeps: int = 0
    traced: devtime.Trace | None = None
    peak_bytes: int | None = None

    def last_good_call(self):
        good = [c for c in self.calls if c.ok]
        return good[-1] if good else None


def _program():
    """The system under test: the port's front door and what the readers
    replay.  Imported here, so that a directory without the program
    fails at this point."""
    names = ("cpd", "als_device", "mttkrp", "coo")
    return {n: importlib.import_module(f"repro_torch.core.{n}") for n in names}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def setup(run: Run, started: float):
    """Everything before the window; returns the benchmark's own copy of
    the tensor (host arrays) and the client."""
    cfg = run.cell.config
    dev = run.device
    t0 = time.perf_counter()
    run.program = _program()
    run.spans["setup.import"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gen = cfg["generator"]
    indices, values = data.stand_in(cfg["shape"], cfg["nnz"], run.seed,
                                    exponent=gen["degree_exponent"],
                                    min_abs=gen["min_abs"], device=dev)
    run.spans["setup.generate"] = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    run.tensor = run.program["coo"].SparseTensor(
        indices.copy(), values.copy(), tuple(cfg["shape"]))
    run.plan = run.program["mttkrp"].make_plan(run.tensor, cfg["kappa"],
                                               device=dev)
    for d in range(len(cfg["shape"])):
        run.plan.device_packed(d)
    _sync(dev)
    run.spans["setup.plan"] = time.perf_counter() - t0

    client = traffic_mod.Client(run.program["cpd"].cpd_als, run.tensor,
                                run.plan, cfg, run.cell.traffic, run.seed, dev)
    t0 = time.perf_counter()
    client.warm_up()
    run.spans["setup.warm"] = time.perf_counter() - t0
    run.spans["setup"] = time.perf_counter() - started
    return indices, values, client


def window(run: Run, client) -> None:
    calls, elapsed = client.closed_loop(run.seconds)
    run.calls = calls
    run.window_s = elapsed
    run.window_sweeps = sum(c.result.iters for c in calls if c.ok)
    if run.trace:
        n = run.cell.traffic["traced_calls"]
        run.traced = devtime.profile(
            lambda: client.closed_loop(math.inf, first=len(calls),
                                       max_calls=n)[0])
        run.calls = calls + run.traced.result
    if run.device.type == "cuda":
        run.peak_bytes = int(torch.cuda.max_memory_allocated(run.device))


def read_metrics(run: Run, entries) -> dict:
    """Each entry's reader; a reader that finds nothing is left out."""
    out = {}
    for m in entries:
        value = metric_reader(m["name"], run.cell.bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_block(run: Run) -> dict:
    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    block = {"platform": "gpu",
             "kind": torch.cuda.get_device_name(run.device),
             "count": run.cell.workload["chips"],
             "memory_peak_bytes": run.peak_bytes}
    if run.traced is not None:
        block["busy_s"] = run.traced.busy_s()
        block["window_s"] = run.traced.window_s
    return block


def card_line() -> str:
    """The card's name and power limit (``nvidia-smi``) beside the peaks
    the shares are read against, which assume the full 700 W."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        out = f"nvidia-smi unavailable ({type(exc).__name__})"
    return (f"card: {out}; peaks ({counts.PEAKS['name']}, 700 W): "
            f"{counts.PEAKS['hbm_bytes_per_s']:.3g} B/s, "
            f"{counts.PEAKS['fp32_flops_per_s']:.3g} FP32 FLOP/s")


def free_program(run: Run) -> None:
    """Drop the program's state before the reference runs."""
    run.plan = None
    run.tensor = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", started: float | None = None,
             require_cards: bool = True) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    t0 = time.perf_counter()
    started = t0 if started is None else started
    if require_cards:
        guard.require_cards(cell.workload["chips"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.empty(1, device=dev)      # the context, before any span
    cfg = cell.config
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=dev,
              shape=tuple(cfg["shape"]), nnz=cfg["nnz"], rank=cfg["rank"])
    # Python's and torch's start, the benchmark's files; then the card's.
    run.spans["setup.start"] = t0 - started
    run.spans["setup.card"] = time.perf_counter() - t0
    indices, values, client = setup(run, started)
    t0 = time.perf_counter()
    window(run, client)
    run.spans["window"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    dev_info = device_block(run)
    extra = {}
    if trace and run.traced is not None:
        extra["breakdown"] = devtime.breakdown(run.traced)
    attempted = len(run.calls)
    failed = sum(not c.ok for c in run.calls)
    run.spans["readers"] = time.perf_counter() - t0
    free_program(run)
    t0 = time.perf_counter()
    readings = check.compare(run.calls, cell, indices, values, seed, dev)
    run.spans["check"] = time.perf_counter() - t0
    if dev.type == "cuda":
        print(card_line(), file=sys.stderr)
    for name, seconds in run.spans.items():
        print(f"span {name}: {seconds:.3f} s", file=sys.stderr)
    times = sorted(c.seconds for c in run.calls)
    if times:
        print(f"calls: {len(times)}, seconds min {times[0]:.4f} median "
              f"{times[len(times) // 2]:.4f} max {times[-1]:.4f}",
              file=sys.stderr)
    correct, table = check.verdict(readings, cell.limits)
    correct = correct and failed == 0 and attempted > 0
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev_info, **extra,
            "checks": {k: {"value": _finite(v["value"]),
                           "limit": _finite(v["limit"])}
                       for k, v in table.items()}}


def emit(line: dict) -> int:
    """Print the comparisons as the last lines of standard error, then the
    result line as the last line of standard output; refuse (exit 3) where a forbidden module
    was loaded."""
    found = guard.forbidden_modules()
    if found:
        print(f"refused: modules {found} were imported in the measuring "
              f"process", file=sys.stderr)
        return 3
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, v in line["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
