"""setup_s: seconds from the process's start of the harness to the
window: imports, the stand-in tensor, the program's plan and uploads, the
warm-up call (host clock)."""


def read(run):
    return run.spans.get("setup")
