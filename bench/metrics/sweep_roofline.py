"""sweep_roofline: the counted least time of one sweep (N MTTKRPs, grams,
solves, the fit's last step; ``harness/counts.py``) at the card's
data-sheet peaks, over the device's busy time per sweep in the profiled
stretch of whole calls (``torch.profiler``, the union of every activity,
over the sweeps those calls returned).  Each call's uploads count as its
sweeps' work."""
from bench.harness import counts


def read(run):
    tr = run.traced
    if tr is None or not tr.device:
        return None
    sweeps = sum(c.result.iters for c in tr.result if c.ok)
    busy = tr.busy_s()
    if sweeps == 0 or busy <= 0:
        return None
    least = counts.least_seconds(
        counts.sweep_counts(run.shape, run.nnz, run.rank))
    return 100.0 * least / (busy / sweeps)
