"""graph_sweep_share: ``CPDResult.graph_sweeps`` over ``CPDResult.iters``,
summed over the window's calls: the share of sweeps the fused engine
replayed from captured CUDA graphs (an exact count); left out where a
result has no such counter."""


def read(run):
    done = [c.result for c in run.calls if c.ok]
    sweeps = sum(r.iters for r in done)
    if not sweeps or not all(hasattr(r, "graph_sweeps") for r in done):
        return None
    return sum(r.graph_sweeps for r in done) / sweeps
