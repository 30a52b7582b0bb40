"""The program's own spans (``repro_torch.obs.trace``), read once per run.

The port opens a profiler record for each of its spans while a
``torch.profiler`` records, so its spans sit among the profiler's host
events on the profiler's clock, and the kernels queued inside a span
count in that record's ``device_time_total``.  ``read(run)`` profiles the
traffic's ``traced_calls`` whole calls through the traffic's ``Client``
and the public ``cpd_als`` and sums, per span name, the host seconds, the
device seconds and the count.  It then plans the same tensor a second
time on the host only (``make_plan`` and every mode's ``packed``, no
upload) under ``obs.trace.capture()`` and sums the planning spans' host
seconds.  The result is cached on the run; a program without the spans
gives empty sums, and the readers then leave their metric out.
"""
from __future__ import annotations

import dataclasses
import importlib
import math

import torch

from . import traffic as traffic_mod

CALL_SPANS = ("cpd.call", "cpd.prepare", "als.window", "als.mttkrp",
              "als.update", "als.fit", "cpd.finish")
PLAN_SPANS = ("plan.layouts", "plan.pack")
_CACHE = "_program_spans"


@dataclasses.dataclass
class Spans:
    """``host_s``, ``device_s``, ``count``: per span name over the profiled
    calls (``device_s`` None where the profiler saw no device activity);
    ``sweeps`` those calls returned; ``plan_s``: host seconds per planning
    span name over the host-only replan."""

    host_s: dict
    device_s: dict | None
    count: dict
    sweeps: int
    plan_s: dict


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile_calls(run):
    """The traffic's ``traced_calls`` whole calls under ``torch.profiler``:
    (events, calls)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    client = traffic_mod.Client(run.program["cpd"].cpd_als, run.tensor,
                                run.plan, run.cell.config, run.cell.traffic,
                                run.seed, run.device)
    _sync(run.device)
    with profile(activities=activities) as prof:
        calls, _ = client.closed_loop(
            math.inf, first=len(run.calls),
            max_calls=run.cell.traffic["traced_calls"])
        _sync(run.device)
    return prof.events(), calls


def _replan_spans(run) -> dict:
    """Host seconds per planning span of ``make_plan`` and every mode's
    ``packed`` on the run's tensor, nothing uploaded."""
    trace = importlib.import_module("repro_torch.obs.trace")
    make_plan = run.program["mttkrp"].make_plan
    with trace.capture("bench.replan") as tr:
        plan = make_plan(run.tensor, run.cell.config["kappa"],
                         device=run.device)
        for d in range(len(run.shape)):
            plan.packed(d)
    out: dict[str, float] = {}
    for r in tr.records():
        if r["kind"] == "span" and r["name"] in PLAN_SPANS:
            out[r["name"]] = out.get(r["name"], 0.0) + r["dur_us"] / 1e6
    return out


def measure(run) -> Spans:
    from torch.autograd import DeviceType

    events, calls = _profile_calls(run)
    host_s: dict[str, float] = {}
    device_s: dict[str, float] = {}
    count: dict[str, int] = {}
    on_device = False
    for e in events:
        if e.device_type != DeviceType.CPU:
            on_device = on_device or e.device_type == DeviceType.CUDA
            continue
        if e.name not in CALL_SPANS:
            continue
        host_s[e.name] = host_s.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6
        device_s[e.name] = (device_s.get(e.name, 0.0)
                            + e.device_time_total / 1e6)
        count[e.name] = count.get(e.name, 0) + 1
    sweeps = sum(c.result.iters for c in calls if c.ok)
    # A program without the spans has nothing to replan for.
    plan_s = _replan_spans(run) if "cpd.call" in count else {}
    return Spans(host_s=host_s, device_s=device_s if on_device else None,
                 count=count, sweeps=sweeps, plan_s=plan_s)


def read(run) -> Spans | None:
    """The run's spans, measured at the first call and cached on it; None
    without a plan or tensor to run on."""
    if run.tensor is None or run.plan is None:
        return None
    cached = getattr(run, _CACHE, None)
    if cached is None:
        cached = measure(run)
        setattr(run, _CACHE, cached)
    return cached


def device_ms_per_sweep(run, name: str) -> float | None:
    """Device milliseconds under span ``name`` per profiled sweep."""
    s = read(run)
    if s is None or s.device_s is None or not s.sweeps or name not in s.count:
        return None
    return s.device_s[name] / s.sweeps * 1e3
