"""sweep_ms: the untraced window's wall time over the ALS sweeps of the
calls made in it (host clock).  Each call's front door, uploads and host
reads are inside."""


def read(run):
    if run.window_sweeps == 0:
        return None
    return run.window_s / run.window_sweeps * 1e3
