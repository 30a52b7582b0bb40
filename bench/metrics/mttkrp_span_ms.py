"""mttkrp_span_ms: device milliseconds under the program's ``als.mttkrp``
spans per sweep, the N modes summed (``harness/spans.py``): the slab
kernel and the unrelabel of each mode, measured inside the calls; left
out where the program has no such span or the profiler saw no device
activity."""
from bench.harness import spans


def read(run):
    return spans.device_ms_per_sweep(run, "als.mttkrp")
