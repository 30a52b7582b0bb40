"""mttkrp_roofline: the counted least time of the N mode MTTKRPs
(``harness/counts.py``: nonzeros, factors and outputs each moved once) at
the card's data-sheet peaks, over the summed device time of a replay of
the public ``repro_torch.core.mttkrp.mttkrp(plan, factors, d)`` for every
mode on the last call's factors (``torch.profiler``, every activity of
the replay)."""
import torch

from bench.harness import counts, devtime

REPS = 5


def read(run):
    last = run.last_good_call()
    if last is None:
        return None
    mttkrp = run.program["mttkrp"].mttkrp
    backend = run.cell.config["backend"]
    factors = [torch.as_tensor(F, device=run.device)
               for F in last.result.factors]

    def all_modes():
        for d in range(len(factors)):
            mttkrp(run.plan, factors, d, backend=backend)

    seconds = devtime.device_seconds(all_modes, REPS)
    if not seconds:
        return None
    least = sum(counts.least_seconds(
        counts.mttkrp_counts(run.shape, run.nnz, run.rank, d))
        for d in range(len(factors)))
    return 100.0 * least / seconds
