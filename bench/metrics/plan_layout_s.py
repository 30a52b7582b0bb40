"""plan_layout_s: host seconds of the program's ``plan.layouts`` span
(``build_all_mode_layouts`` in ``make_plan``) when the run's tensor is
planned again on the host (``harness/spans.py``).  Left out where the
program has no such span."""
from bench.harness import spans


def read(run):
    s = spans.read(run)
    return None if s is None else s.plan_s.get("plan.layouts")
