"""host_syncs_per_sweep: ``CPDResult.host_syncs`` over ``CPDResult.iters``,
summed over the window's calls (an exact count)."""


def read(run):
    done = [c.result for c in run.calls if c.ok]
    sweeps = sum(r.iters for r in done)
    return sum(r.host_syncs for r in done) / sweeps if sweeps else None
