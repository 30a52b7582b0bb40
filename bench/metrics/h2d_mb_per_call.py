"""h2d_mb_per_call: the bytes a call copied from host to device, as the
program counts them (``CPDResult.h2d_bytes``: the initial state and the
fit data), averaged over the window's calls, in 1e6 bytes.  Left out
where the program's result has no such count."""


def read(run):
    counts = [getattr(c.result, "h2d_bytes", None) for c in run.calls if c.ok]
    if not counts or any(n is None for n in counts):
        return None
    return sum(counts) / len(counts) / 1e6
