"""plan_s: host seconds of the program's planning in set-up: ``make_plan``,
every mode's ``device_packed`` upload, a synchronise."""


def read(run):
    return run.spans.get("setup.plan")
