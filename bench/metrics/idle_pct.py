"""idle_pct: the share of the profiled stretch of whole calls in which no
kernel, copy or fill ran on the card (the union of the device's
intervals, not their sum)."""


def read(run):
    tr = run.traced
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
