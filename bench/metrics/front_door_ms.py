"""front_door_ms: host milliseconds of the program's ``cpd.prepare`` and
``cpd.finish`` spans per call (``harness/spans.py``): the state and
fit-data uploads with the host norm, the mode data and block lookups,
then the fits read, the factor download and the result.  Left out where
the program has no such spans."""
from bench.harness import spans


def read(run):
    s = spans.read(run)
    if s is None or not s.count.get("cpd.call") or not all(
            n in s.host_s for n in ("cpd.prepare", "cpd.finish")):
        return None
    return (s.host_s["cpd.prepare"] + s.host_s["cpd.finish"]) / s.count[
        "cpd.call"] * 1e3
