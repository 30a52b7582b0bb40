"""plan_sort_s: host seconds of the program's ``plan.sort`` spans (each
mode copy's ordering of the nonzeros, which the program closes once the
device has finished it), summed over the modes, when the run's tensor is
planned again (``make_plan`` on the run's device, nothing packed) under
``obs.trace.capture()``.  A plan of one nonzero at the run's shape, made
first, shows whether the program has the span; where it has not, the
metric is left out and the tensor is not planned again."""
import importlib


def _sort_s(run, tensor):
    trace = importlib.import_module("repro_torch.obs.trace")
    with trace.capture("bench.plan_sort") as tr:
        run.program["mttkrp"].make_plan(tensor, run.cell.config["kappa"],
                                        device=run.device)
    sorts = [r["dur_us"] for r in tr.records()
             if r["kind"] == "span" and r["name"] == "plan.sort"]
    return sum(sorts) / 1e6 if sorts else None


def read(run):
    if run.tensor is None:
        return None
    probe = run.program["coo"].SparseTensor(
        run.tensor.indices[:1].copy(), run.tensor.values[:1].copy(),
        run.tensor.shape)
    if _sort_s(run, probe) is None:
        return None
    return _sort_s(run, run.tensor)
