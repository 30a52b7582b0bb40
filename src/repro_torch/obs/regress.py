"""Noise-aware benchmark regression gate over the history ledger (a copy
of ``repro.obs.regress``).

Compares the last k history records per section (``obs.history``)
against the committed baseline (by default ``results/BENCH_torch_baseline.json``) with
per-metric *direction awareness* — latencies and per-iteration seconds
are down-good, hit rates / speedups / occupancy are up-good — and
tolerance bands calibrated from the k repeats:

  * **min-of-k aggregation.**  The fresh value a metric is judged on is
    its best over the k repeats (min for down-good, max for up-good) —
    the standard defense against one noisy repeat: a transient stall in
    one run cannot fail the gate, while a *real* regression moves every
    repeat and therefore the best.
  * **calibrated bands.**  Each spec carries a static tolerance; the
    effective band additionally widens to ``noise_mult`` x the observed
    relative spread of the repeats — the LARGER of the fresh repeats'
    spread and the spread recorded in the baseline's ``noise`` block
    when it was built — so a metric that is demonstrably jittery is
    held to a band its own noise justifies even when the fresh repeats
    happen to agree with each other on the wrong side of the baseline.
    The band is CAPPED at ``MAX_REL_TOL`` so no amount of jitter can
    mask a 2x change — the injected-slowdown guarantee the tests pin.
  * **portable vs timing metrics.**  Ratio/structural metrics (cache
    hit rate, speedup, padding, occupancy, overlap, imbalance,
    host_syncs) are machine-portable and always gated.  Absolute wall
    times are only comparable on the machine that wrote the baseline;
    CI (whose runners differ from the baseline writer) passes
    ``--portable-only`` to demote them to informational, while the
    default local gate checks both.

Unknown metrics are never gated (reported as unwatched) — the gate only
enforces directions it actually knows.

CLI::

    # gate the last 2 records per section against the baseline
    python -m repro_torch.obs.regress --check --sections serve obs --repeats 2

    # bless the current history tail as the new baseline
    python -m repro_torch.obs.regress --update-baseline --sections serve obs

Pure stdlib.
"""
from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import json
import sys

from . import history

__all__ = [
    "MetricSpec", "Finding", "DEFAULT_SPECS", "MAX_REL_TOL", "classify",
    "best", "rel_spread", "compare_metrics", "compare_sections",
    "baseline_from_history", "load_baseline", "main",
]

# No calibrated band may exceed this relative width: a 2x slowdown
# (rel_change = 1.0) is ALWAYS out of band, however noisy the repeats.
MAX_REL_TOL = 0.8

BASELINE_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """How one metric family is judged.  ``pattern`` is an fnmatch over
    the flattened metric name (first matching spec wins); ``direction``
    is "down" (smaller is better) or "up"; ``portable`` marks metrics
    comparable across machines (always gated — timings are not)."""

    pattern: str
    direction: str
    rel_tol: float
    abs_tol: float = 0.0
    portable: bool = True


# Ordered: first match wins.  Up-good ratio metrics come before the
# broad timing patterns so e.g. "cache_hit_rate" never falls through to
# a down-good rule.
DEFAULT_SPECS: tuple[MetricSpec, ...] = (
    # -- portable (machine-independent) ratios and counts ------------------
    MetricSpec("*hit_rate*", "up", 0.05, abs_tol=0.02),
    MetricSpec("*speedup*", "up", 0.25, abs_tol=0.05),
    MetricSpec("*_rps", "up", 0.5, portable=False),   # absolute throughput
    MetricSpec("*overlap_fraction*", "up", 0.30, abs_tol=0.05),
    MetricSpec("*occupancy*", "up", 0.15, abs_tol=0.05),
    MetricSpec("*padding_overhead*", "down", 0.10, abs_tol=0.02),
    MetricSpec("*imbalance*", "down", 0.15, abs_tol=0.05),
    MetricSpec("*host_syncs*", "down", 0.0, abs_tol=0.5),
    MetricSpec("*traces", "down", 0.0, abs_tol=0.5),
    MetricSpec("*err*", "down", 0.5, abs_tol=1e-6),
    MetricSpec("*fit_gap*", "down", 0.5, abs_tol=1e-4),
    # -- timings (same-machine only; CI demotes via --portable-only) -------
    MetricSpec("*latency*", "down", 0.5, portable=False),
    MetricSpec("*_s_per_*", "down", 0.5, portable=False),
    MetricSpec("*s_per_increment*", "down", 0.5, portable=False),
    MetricSpec("*_seconds*", "down", 0.5, portable=False),
    MetricSpec("*merge_s", "down", 0.5, portable=False),
    MetricSpec("*_us*", "down", 0.5, portable=False),
    MetricSpec("*_s", "down", 0.5, portable=False),
)


@dataclasses.dataclass
class Finding:
    """One judged (row, metric): status is "regression", "improved",
    "ok", "info" (known metric, not gated in this mode), "new" (no
    baseline value), or "missing" (baselined metric absent from the
    fresh runs — itself a gate failure: a silently dropped witness)."""

    section: str
    row: str
    metric: str
    direction: str | None
    baseline: float | None
    observed: float | None
    values: tuple[float, ...]
    rel_change: float | None     # + means worse, - means better
    tol: float | None
    status: str

    def describe(self) -> str:
        arrow = {"down": "v-good", "up": "^-good"}.get(self.direction or "",
                                                       "ungated")
        chg = ("" if self.rel_change is None
               else f" change={self.rel_change:+.1%} (band {self.tol:.1%})")
        return (f"[{self.status:10s}] {self.section}:{self.row}:"
                f"{self.metric} ({arrow}) baseline={_fmt(self.baseline)} "
                f"observed={_fmt(self.observed)}{chg}")


def _fmt(x: float | None) -> str:
    return "-" if x is None else f"{x:.6g}"


def classify(metric: str,
             specs: tuple[MetricSpec, ...] = DEFAULT_SPECS
             ) -> MetricSpec | None:
    """First matching spec for a flattened metric name (the part after
    the last '.' also tried, so gauge sub-dict keys like
    ``dispatch.overlap_fraction`` classify by their leaf)."""
    leaf = metric.rsplit(".", 1)[-1]
    for spec in specs:
        if fnmatch.fnmatch(metric, spec.pattern) or \
                fnmatch.fnmatch(leaf, spec.pattern):
            return spec
    return None


def best(values: list[float] | tuple[float, ...], direction: str) -> float:
    """Direction-aware best of k repeats (min for down-good timings,
    max for up-good rates)."""
    if not values:
        raise ValueError("no values")
    return min(values) if direction == "down" else max(values)


def rel_spread(values: list[float] | tuple[float, ...]) -> float:
    """Relative spread (max-min over max-abs) of the k repeats — the
    observed noise the tolerance band is calibrated from.  0 for a
    single repeat (the static band alone applies)."""
    if len(values) < 2:
        return 0.0
    lo, hi = min(values), max(values)
    scale = max(abs(lo), abs(hi))
    return (hi - lo) / scale if scale > 0 else 0.0


def compare_metrics(section: str, row: str, metric: str,
                    baseline: float | None, values: list[float], *,
                    specs: tuple[MetricSpec, ...] = DEFAULT_SPECS,
                    noise_mult: float = 2.0,
                    base_spread: float = 0.0,
                    portable_only: bool = False) -> Finding:
    """Judge one metric: direction-aware best-of-k vs the baseline under
    the calibrated band.  ``base_spread`` is the relative spread the
    baseline recorded for this metric when it was built (0 when the
    baseline predates the ``noise`` block or the metric was steady).
    See the module docstring for the rules."""
    spec = classify(metric, specs)
    if spec is None:
        return Finding(section, row, metric, None, baseline,
                       values[0] if values else None,
                       tuple(values), None, None, "info")
    obs = best(values, spec.direction)
    if baseline is None:
        return Finding(section, row, metric, spec.direction, None, obs,
                       tuple(values), None, None, "new")
    spread = max(rel_spread(values), base_spread)
    tol = min(max(spec.rel_tol, noise_mult * spread), MAX_REL_TOL)
    scale = max(abs(baseline), 1e-12)
    if spec.direction == "down":
        delta = obs - baseline               # + is worse
    else:
        delta = baseline - obs               # + is worse
    rel = delta / scale
    out_of_band = delta > tol * scale + spec.abs_tol
    if out_of_band:
        status = ("regression" if spec.portable or not portable_only
                  else "info")
    elif rel < 0:
        status = "improved"
    else:
        status = "ok"
    return Finding(section, row, metric, spec.direction, baseline, obs,
                   tuple(values), rel, tol, status)


def compare_sections(baseline_doc: dict, records: list[dict],
                     sections: list[str], *, repeats: int = 1,
                     specs: tuple[MetricSpec, ...] = DEFAULT_SPECS,
                     noise_mult: float = 2.0,
                     portable_only: bool = False) -> list[Finding]:
    """Gate ``sections``: the last ``repeats`` history records of each
    vs the committed baseline.  A section with a baseline but no fresh
    records, or a baselined metric absent from every fresh repeat, is a
    "missing" finding (a dropped witness fails the gate too)."""
    findings: list[Finding] = []
    base_sections = baseline_doc.get("sections", {})
    base_noise = baseline_doc.get("noise", {})
    for section in sections:
        base = base_sections.get(section, {})
        noise = base_noise.get(section, {})
        fresh = history.tail(records, section, repeats)
        if not fresh:
            findings.append(Finding(section, "-", "-", None, None, None,
                                    (), None, None, "missing"))
            continue
        per_repeat = [history.row_metrics(r["rows"]) for r in fresh]
        rows = set(base)
        for m in per_repeat:
            rows.update(m)
        for row in sorted(rows):
            brow = base.get(row, {})
            metrics = set(brow)
            for m in per_repeat:
                metrics.update(m.get(row, {}))
            for metric in sorted(metrics):
                values = [m[row][metric] for m in per_repeat
                          if metric in m.get(row, {})]
                bval = brow.get(metric)
                if not values:
                    # Baselined metric vanished from every fresh repeat.
                    if classify(metric, specs) is not None:
                        findings.append(Finding(
                            section, row, metric, None, bval, None, (),
                            None, None, "missing"))
                    continue
                findings.append(compare_metrics(
                    section, row, metric, bval, values, specs=specs,
                    noise_mult=noise_mult,
                    base_spread=noise.get(row, {}).get(metric, 0.0),
                    portable_only=portable_only))
    return findings


# ---------------------------------------------------------------------------
# Baseline build / load
# ---------------------------------------------------------------------------


def baseline_from_history(records: list[dict], sections: list[str], *,
                          repeats: int = 1,
                          specs: tuple[MetricSpec, ...] = DEFAULT_SPECS
                          ) -> dict:
    """Build a baseline document from the ledger tail: per section, the
    direction-aware best of the last ``repeats`` records per metric
    (ungated metrics keep the latest value, for the trend tables), plus
    a ``noise`` block recording each gated metric's relative spread
    across those repeats — check time widens its band to the larger of
    this and the fresh repeats' spread, so jitter witnessed when the
    baseline was blessed keeps protecting later runs whose own repeats
    happen to agree."""
    out_sections: dict[str, dict] = {}
    out_noise: dict[str, dict] = {}
    provenance: dict = {}
    for section in sections:
        fresh = history.tail(records, section, repeats)
        if not fresh:
            raise ValueError(f"history has no records for section "
                             f"{section!r}")
        provenance = {
            "git_sha": fresh[-1]["git_sha"],
            "ts_utc": fresh[-1]["ts_utc"],
            "host": fresh[-1]["host"],
            "device": fresh[-1]["device"],
            "smoke": fresh[-1]["smoke"],
        }
        per_repeat = [history.row_metrics(r["rows"]) for r in fresh]
        rows: dict[str, dict[str, float]] = {}
        noise: dict[str, dict[str, float]] = {}
        names = set()
        for m in per_repeat:
            names.update(m)
        for row in sorted(names):
            metrics: dict[str, float] = {}
            keys = set()
            for m in per_repeat:
                keys.update(m.get(row, {}))
            for metric in sorted(keys):
                values = [m[row][metric] for m in per_repeat
                          if metric in m.get(row, {})]
                spec = classify(metric, specs)
                if spec is None:
                    metrics[metric] = values[-1]
                    continue
                metrics[metric] = best(values, spec.direction)
                spread = rel_spread(values)
                if spread > 0.0:
                    noise.setdefault(row, {})[metric] = spread
            rows[row] = metrics
        out_sections[section] = rows
        if noise:
            out_noise[section] = noise
    return {"schema": BASELINE_SCHEMA, "repeats": repeats,
            "provenance": provenance, "sections": out_sections,
            "noise": out_noise}


def load_baseline(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != BASELINE_SCHEMA:
        raise ValueError(f"{path}: not a schema-{BASELINE_SCHEMA} baseline")
    if not isinstance(doc.get("sections"), dict):
        raise ValueError(f"{path}: baseline missing 'sections'")
    return doc


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None, out=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="noise-aware benchmark regression gate")
    ap.add_argument("--history", default="results/BENCH_torch_history.jsonl")
    ap.add_argument("--baseline", default="results/BENCH_torch_baseline.json")
    ap.add_argument("--sections", nargs="+", required=True)
    ap.add_argument("--repeats", type=int, default=1,
                    help="how many trailing history records per section "
                         "to judge (min-of-k)")
    ap.add_argument("--noise-mult", type=float, default=2.0)
    ap.add_argument("--portable-only", action="store_true",
                    help="gate machine-portable metrics only (CI: the "
                         "runner is not the machine that wrote the "
                         "baseline, so absolute timings are demoted to "
                         "informational)")
    ap.add_argument("--check", action="store_true",
                    help="compare and exit 1 on any regression/missing")
    ap.add_argument("--update-baseline", action="store_true",
                    help="bless the history tail as the new baseline")
    args = ap.parse_args(argv)
    out = out or sys.stdout
    if args.check == args.update_baseline:
        ap.error("exactly one of --check / --update-baseline required")

    records = history.load(args.history)

    if args.update_baseline:
        doc = baseline_from_history(records, args.sections,
                                    repeats=args.repeats)
        with open(args.baseline, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        n = sum(len(m) for rows in doc["sections"].values()
                for m in rows.values())
        print(f"baseline updated: {args.baseline} "
              f"({len(doc['sections'])} section(s), {n} metric(s), "
              f"sha {doc['provenance'].get('git_sha', '?')[:12]})",
              file=out)
        return 0

    baseline_doc = load_baseline(args.baseline)
    findings = compare_sections(
        baseline_doc, records, args.sections, repeats=args.repeats,
        noise_mult=args.noise_mult, portable_only=args.portable_only)
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.status] = counts.get(f.status, 0) + 1
    bad = [f for f in findings if f.status in ("regression", "missing")]
    for f in findings:
        if f.status in ("regression", "missing", "improved"):
            print(f.describe(), file=out)
    print(f"regression gate: {len(findings)} judged — "
          + ", ".join(f"{k}={v}" for k, v in sorted(counts.items())),
          file=out)
    if bad:
        print(f"FAIL: {len(bad)} out-of-band metric(s); re-run, or bless "
              f"an intentional change with --update-baseline", file=out)
        return 1
    print("PASS: every gated metric within its tolerance band", file=out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
