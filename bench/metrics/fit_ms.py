"""fit_ms: device milliseconds of one evaluation of the program's sparse
fit (``als_device._build_sparse_fit``), replayed on the last call's
result and read by ``torch.profiler`` as the summed device time of the
replay.  Left out where the program no longer has that function."""
import torch

from bench.harness import devtime

REPS = 5


def read(run):
    als = run.program["als_device"]
    last = run.last_good_call()
    if last is None or not hasattr(als, "_build_sparse_fit"):
        return None
    dev = run.device
    factors = [torch.as_tensor(F, device=dev) for F in last.result.factors]
    grams = [F.T @ F for F in factors]
    weights = torch.as_tensor(last.result.weights, dtype=torch.float32,
                              device=dev)
    fit = als._build_sparse_fit(len(factors), run.rank)
    fit_data = als.make_fit_data(run.tensor, dev)
    seconds = devtime.device_seconds(lambda: fit(factors, grams, weights,
                                             fit_data), REPS)
    return None if seconds is None else seconds * 1e3
