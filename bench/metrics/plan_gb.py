"""plan_gb: the bytes of the run's plan on the card after set-up, as the
program counts them (``MTTKRPPlan.device_bytes``: the packed mode copies,
their chunk tables and row maps), in 1e9 bytes.  Left out where the
program's plan has no such counter."""


def read(run):
    nbytes = getattr(run.plan, "device_bytes", None)
    return None if nbytes is None else nbytes / 1e9
