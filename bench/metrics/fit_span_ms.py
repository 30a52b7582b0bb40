"""fit_span_ms: device milliseconds under the program's ``als.fit`` span
per sweep (``harness/spans.py``: ``torch.profiler`` over whole calls, the
kernels queued inside each span by the profiler's correlation).  The
sweep's sparse fit measured where it runs; left out where the program
has no such span or the profiler saw no device activity."""
from bench.harness import spans


def read(run):
    return spans.device_ms_per_sweep(run, "als.fit")
