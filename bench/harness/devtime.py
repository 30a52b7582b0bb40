"""Device time from ``torch.profiler``.

``profile`` reads the device's activities (kernels, copies, fills) and
the host's operations of one traced stretch.  Busy time is the union of
the device's intervals, not their sum as in ``chip_smoke.py::device_idle``,
so overlapping activities count once.
"""
from __future__ import annotations

import dataclasses

import torch

WINDOW_LABEL = "bench.traced_window"


@dataclasses.dataclass
class Trace:
    """One traced stretch: ``device`` and ``host`` are ``(name, start_us,
    end_us)`` on the profiler's clock; ``start_us``/``end_us`` bound the
    stretch; ``result`` is what the traced function returned."""

    device: list
    host: list
    start_us: float
    end_us: float
    result: object = None

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.device)) / 1e6

    def kernel_s(self) -> float:
        """Summed device time of every activity (overlaps count twice)."""
        return sum(e - s for _, s, e in self.device) / 1e6


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``(name, start, end)`` intervals as sorted disjoint
    ``(start, end)`` pairs."""
    out: list[list[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def profile(fn, attempts: int = 3) -> Trace:
    """``fn()`` under ``torch.profiler``, the card synchronised before and
    after.  A stretch in which the profiler recorded no device activity is
    traced again, at most ``attempts`` times in all; after that the trace
    comes back with no device activity and readers leave their metric out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    for _ in range(attempts):
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_LABEL):
                result = fn()
                torch.cuda.synchronize()
        device, host, bounds = [], [], None
        for e in prof.events():
            span = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                # A label's own interval on the device's timeline covers the
                # activities under it; it is not one of them.
                if not (e.name == WINDOW_LABEL
                        or getattr(e, "is_user_annotation", False)):
                    device.append(span)
            elif e.name == WINDOW_LABEL:
                bounds = span
            else:
                host.append(span)
        if device and bounds is not None:
            break
    if bounds is None:
        starts = [s for _, s, _ in device + host] or [0.0]
        ends = [e for _, _, e in device + host] or [0.0]
        bounds = (WINDOW_LABEL, min(starts), max(ends))
    return Trace(device=device, host=host, start_us=bounds[1],
                 end_us=bounds[2], result=result)


def device_seconds(fn, reps: int) -> float | None:
    """Device time of one ``fn()``: the summed time of the device's
    activities over ``reps`` traced calls (one untraced call first), over
    ``reps``.  None when the profiler recorded none."""
    fn()

    def calls():
        for _ in range(reps):
            fn()

    tr = profile(calls)
    return tr.kernel_s() / reps if tr.device else None


def breakdown(tr: Trace, top: int = 10) -> dict:
    """``device_ops``: the device activities that took most time, summed by
    name; ``idle_gaps``: the device's idle time inside the stretch, summed
    by the innermost host operation running at each gap's middle ("python"
    where none was), longest first."""
    by_op: dict[str, float] = {}
    for name, s, e in tr.device:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
    idle = []
    cursor = tr.start_us
    for s, e in union(tr.device) + [(tr.end_us, tr.end_us)]:
        if s > cursor:
            idle.append((cursor, s))
        cursor = max(cursor, e)
    # Sweep the gaps' middles in order over the host operations sorted by
    # start; the operations still running at a middle are few (the nesting).
    host = sorted(tr.host, key=lambda h: h[1])
    gaps: dict[str, float] = {}
    active: list = []
    j = 0
    for a, b in idle:
        mid = (a + b) / 2
        while j < len(host) and host[j][1] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[2] >= mid]
        name = max(active, key=lambda h: h[1])[0] if active else "python"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return {
        "device_ops": [[k[:120], v] for k, v in sorted(
            by_op.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k[:120], v] for k, v in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:top]],
    }
