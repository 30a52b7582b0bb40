"""Append-only benchmark-history ledger (a copy of ``repro.obs.history``).

One schema-validated JSON record per benchmark section run, appended
(never rewritten), so a checkout accumulates a trajectory of every
tracked metric.  A record carries what attributes a shift after the
fact: provenance (git sha and dirty flag, UTC timestamp, host, framework
and device versions), the section's rows verbatim with the plan
fingerprints they report, the run config and the wall time.  The schema
is the reference's, field names included: the framework version goes in
``jax_version`` (the port's benchmark writes torch's there), so one
reader serves both packages' ledgers.  The port's default ledger is
``results/BENCH_torch_history.jsonl``.

Consumers:

  * ``repro_torch.obs.regress`` -- the noise-aware regression gate;
  * ``python -m repro_torch.obs.report --history`` -- trend tables;
  * ``python -m repro_torch.obs.history validate <path>`` -- the JSONL
    schema check (exit 1 on the first malformed record).

Pure stdlib, so the ledger loads on any checkout.
"""
from __future__ import annotations

import json
import math
import os
import sys

__all__ = [
    "SCHEMA_VERSION", "make_record", "validate_record", "append", "load",
    "tail", "row_metrics", "plan_fingerprints",
]

SCHEMA_VERSION = 1

# Top-level fields every history record must carry, with their types.
_REQUIRED: dict[str, type | tuple] = {
    "schema": int,
    "kind": str,              # always "bench" today; versioned for growth
    "section": str,
    "ts_utc": str,
    "git_sha": str,
    "host": str,
    "jax_version": str,
    "device": str,
    "wall_s": (int, float),
    "smoke": bool,
    "config": dict,
    "rows": list,
}

# Keys a bench row may use as its identity, in precedence order (the
# sections are not uniform: serve rows key on "stream", paper-table rows
# on "dataset", system rows on "name").
_ROW_NAME_KEYS = ("name", "dataset", "stream")


def validate_record(rec: object) -> None:
    """Raise ``ValueError`` naming the first schema violation."""
    if not isinstance(rec, dict):
        raise ValueError(f"history record must be an object, got "
                         f"{type(rec).__name__}")
    for key, typ in _REQUIRED.items():
        if key not in rec:
            raise ValueError(f"history record missing required field "
                             f"{key!r} (section={rec.get('section')!r})")
        if not isinstance(rec[key], typ):
            raise ValueError(
                f"history field {key!r} must be "
                f"{getattr(typ, '__name__', typ)}, got "
                f"{type(rec[key]).__name__}")
    if rec["schema"] != SCHEMA_VERSION:
        raise ValueError(f"unsupported history schema {rec['schema']} "
                         f"(this checkout reads {SCHEMA_VERSION})")
    for i, row in enumerate(rec["rows"]):
        if not isinstance(row, dict):
            raise ValueError(
                f"history record rows[{i}] must be an object, got "
                f"{type(row).__name__} (section={rec['section']!r})")


def make_record(section: str, *, rows: list | None, wall_s: float,
                config: dict, provenance: dict) -> dict:
    """Build (and validate) one history record.  ``provenance`` is the
    benchmark's provenance dict plus a fresh ``ts_utc``;
    sections that return no structured rows record an empty list."""
    rows = [r for r in (rows or []) if isinstance(r, dict)]
    rec = {
        "schema": SCHEMA_VERSION,
        "kind": "bench",
        "section": str(section),
        "ts_utc": str(provenance.get("ts_utc", "")),
        "git_sha": str(provenance.get("git_sha", "unknown")),
        "git_dirty": bool(provenance.get("git_dirty", False)),
        "host": str(provenance.get("host", "unknown")),
        "jax_version": str(provenance.get("jax_version", "unknown")),
        "device": str(provenance.get("device", "unknown")),
        "wall_s": float(wall_s),
        "smoke": bool(config.get("smoke", False)),
        "config": dict(config),
        "plan_fingerprints": plan_fingerprints(rows),
        "rows": rows,
    }
    validate_record(rec)
    return rec


def append(path: str | os.PathLike, record: dict) -> None:
    """Validate and append one record (one JSON line).  Append-only by
    construction: the ledger is never rewritten, so concurrent sections
    and historical runs can only add lines."""
    validate_record(record)
    with open(path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")


def load(path: str | os.PathLike, *, strict: bool = True) -> list[dict]:
    """Read the ledger back (oldest first).  ``strict`` validates every
    record and raises on the first malformed line — the CI schema gate;
    ``strict=False`` skips malformed lines (forensics on a damaged
    ledger)."""
    out: list[dict] = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                validate_record(rec)
            except (json.JSONDecodeError, ValueError) as exc:
                if strict:
                    raise ValueError(
                        f"{path}:{lineno}: {exc}") from exc
                continue
            out.append(rec)
    return out


def tail(records: list[dict], section: str, k: int) -> list[dict]:
    """The last ``k`` records for ``section``, oldest first."""
    if k < 1:
        raise ValueError("k must be >= 1")
    sec = [r for r in records if r.get("section") == section]
    return sec[-k:]


def plan_fingerprints(rows: list[dict]) -> list[str]:
    """The distinct plan fingerprints the section's rows reported
    (``core.plan.PartitionPlan.describe()`` strings), sorted — part of
    the record so a perf shift is attributable to a planning change."""
    return sorted({str(r["plan"]) for r in rows
                   if isinstance(r, dict) and isinstance(r.get("plan"), str)})


def _row_name(row: dict, index: int) -> str:
    for key in _ROW_NAME_KEYS:
        v = row.get(key)
        if isinstance(v, str) and v:
            return v
    return f"row[{index}]"


def row_metrics(rows: list[dict]) -> dict[str, dict[str, float]]:
    """Flatten a section's rows to ``{row_name: {metric: float}}`` —
    the shape the regression gate and the trend tables consume.

    Numeric scalar fields only; bools and non-finite floats are skipped
    (they are flags/sentinels, not metrics).  Nested dicts of numerics
    (the dispatch/queue gauge sub-dicts) flatten one level with a dotted
    key; deeper nesting and lists are dropped.
    """
    out: dict[str, dict[str, float]] = {}
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            continue
        metrics: dict[str, float] = {}

        def put(key: str, v: object) -> None:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return
            v = float(v)
            if math.isfinite(v):
                metrics[key] = v

        for k, v in row.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    put(f"{k}.{kk}", vv)
            else:
                put(str(k), v)
        if metrics:
            out[_row_name(row, i)] = metrics
    return out


def main(argv: list[str] | None = None) -> int:
    """``python -m repro_torch.obs.history validate PATH...`` — exit 1 (with
    the offending line named) on the first malformed record."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "validate" or len(argv) < 2:
        print("usage: python -m repro_torch.obs.history validate PATH...",
              file=sys.stderr)
        return 2
    for path in argv[1:]:
        try:
            records = load(path, strict=True)
        except (OSError, ValueError) as exc:
            print(f"INVALID {exc}", file=sys.stderr)
            return 1
        sections = sorted({r["section"] for r in records})
        print(f"{path}: {len(records)} record(s) OK; "
              f"sections: {', '.join(sections) if sections else '(none)'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
