"""Terminal dashboard over obs artifacts (a copy of ``repro.obs.report``):
``python -m repro_torch.obs.report``.

Reads any mix of

  * JSONL trace dumps (``Tracer.dump_jsonl`` — first line is meta),
  * Chrome-trace JSON exports (``Tracer.dump_chrome``),
  * ``BENCH_*.json`` documents: ``obs.calibrate`` rows get the
    calibration tables, rows carrying ``ServiceMetrics.snapshot()``
    sub-dicts the dispatch/streams/queue/health gauge tables,

auto-detected per file, and renders:

  * a span tree with total/self wall time aggregated by name along the
    parent chain (children's totals are subtracted from the parent's
    self time),
  * the build ledger — ``ledger.compile`` instant events (one per
    window function built, ``obs.ledger``) grouped by cache kind,
  * the predicted-vs-observed and load-imbalance tables from BENCH rows,
  * the serving gauges: pod/double-buffer dispatch, per-session
    streaming, queue depth/age, and SLO health,
  * ``--history`` — trend tables over the last k runs per section in
    ``results/BENCH_torch_history.jsonl`` (gated metrics only, newest
    rightmost).

Pure stdlib, so the dashboard works on any checkout.
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict

from . import history as obs_history
from . import regress as obs_regress
from . import trace as obs_trace

_INDENT = "  "


# ---------------------------------------------------------------------------
# Span-tree aggregation
# ---------------------------------------------------------------------------


def _normalize(records: list[dict]) -> tuple[list[dict], list[dict]]:
    """(spans, events) from either JSONL records or Chrome trace events."""
    spans, events = [], []
    for r in records:
        kind = r.get("kind")
        if kind == "span":
            spans.append(r)
        elif kind == "event":
            events.append(r)
        elif "ph" in r:                       # Chrome trace event
            if r["ph"] == "X":
                spans.append({
                    "kind": "span", "id": r.get("args", {}).get("id"),
                    "parent": r.get("args", {}).get("parent"),
                    "name": r["name"], "cat": r.get("cat", "app"),
                    "tid": r.get("tid", 0), "ts_us": r.get("ts", 0.0),
                    "dur_us": r.get("dur", 0.0),
                    "args": r.get("args", {}),
                })
            elif r["ph"] == "i":
                events.append({
                    "kind": "event", "name": r["name"],
                    "cat": r.get("cat", "app"),
                    "args": r.get("args", {}),
                })
    return spans, events


def aggregate_tree(spans: list[dict]) -> dict:
    """Aggregate spans by their name-path (root → ... → name).

    Returns {path_tuple: {"count", "total_us", "self_us"}}; self time is
    total minus the sum of direct children's totals, floored at zero
    (clock granularity can make child sums overshoot).
    """
    by_id = {s["id"]: s for s in spans if s.get("id") is not None}

    def path_of(s):
        parts, seen = [], set()
        cur = s
        while cur is not None and cur["id"] not in seen:
            seen.add(cur["id"])
            parts.append(cur["name"])
            cur = by_id.get(cur.get("parent"))
        return tuple(reversed(parts))

    agg: dict = defaultdict(lambda: {"count": 0, "total_us": 0.0,
                                     "self_us": 0.0})
    child_total: dict = defaultdict(float)
    for s in spans:
        p = path_of(s)
        agg[p]["count"] += 1
        agg[p]["total_us"] += s["dur_us"]
        if len(p) > 1:
            child_total[p[:-1]] += s["dur_us"]
    for p, row in agg.items():
        row["self_us"] = max(row["total_us"] - child_total.get(p, 0.0), 0.0)
    return dict(agg)


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:8.3f}s "
    if us >= 1e3:
        return f"{us / 1e3:8.3f}ms"
    return f"{us:8.1f}µs"


def render_tree(spans: list[dict], out=None) -> None:
    out = out or sys.stdout
    agg = aggregate_tree(spans)
    if not agg:
        print("  (no spans)", file=out)
        return
    print(f"  {'total':>10}  {'self':>10}  {'count':>6}  span", file=out)
    for path in sorted(agg, key=lambda p: (p[:1], -agg[p]["total_us"])):
        row = agg[path]
        name = _INDENT * (len(path) - 1) + path[-1]
        print(f"  {_fmt_us(row['total_us'])}  {_fmt_us(row['self_us'])}"
              f"  {row['count']:6d}  {name}", file=out)


def render_ledger(events: list[dict], out=None) -> None:
    """Group ledger.compile instant events (one per registered
    executable) by kind — the trace-side view of the retrace ledger."""
    out = out or sys.stdout
    compiles = [e for e in events if e["name"] == "ledger.compile"]
    if not compiles:
        print("  (no ledger.compile events)", file=out)
        return
    by_kind: dict = defaultdict(list)
    for e in compiles:
        by_kind[e.get("args", {}).get("kind", "?")].append(
            e.get("args", {}).get("key", "?"))
    for kind in sorted(by_kind):
        keys = by_kind[kind]
        print(f"  {kind:16s} {len(keys):3d} executable(s)", file=out)
        for k in keys:
            print(f"    - {k}", file=out)


# ---------------------------------------------------------------------------
# BENCH_obs tables
# ---------------------------------------------------------------------------


def render_bench(doc: dict, out=None) -> None:
    out = out or sys.stdout
    rows = doc.get("rows", doc if isinstance(doc, list) else [])
    ratio = [r for r in rows if r.get("section") == "ratio"]
    imb = [r for r in rows if r.get("section") == "imbalance"]
    ledger = [r for r in rows if r.get("section") == "ledger"]
    if ratio:
        print("  predicted vs observed (per backend):", file=out)
        print(f"    {'dataset':10s} {'backend':8s} {'pred_s':>10} "
              f"{'meas_s':>10} {'pred/obs':>10} {'compile_s':>10} "
              f"{'steady_s':>10}", file=out)
        for r in ratio:
            po = r.get("predicted_over_observed")
            print(f"    {r['dataset']:10s} {r['backend']:8s} "
                  f"{_num(r.get('predicted_s')):>10} "
                  f"{_num(r.get('measured_s')):>10} "
                  f"{_num(po):>10} "
                  f"{_num(r.get('compile_overhead_s')):>10} "
                  f"{_num(r.get('steady_window_s')):>10}", file=out)
    if imb:
        print("  load imbalance (max/mean shard time):", file=out)
        print(f"    {'dataset':10s} {'mode':>4} {'scheme':10s} "
              f"{'measured':>9} {'nnz-pred':>9}", file=out)
        for r in imb:
            for m in r.get("per_mode", []):
                print(f"    {r['dataset']:10s} {m['mode']:4d} "
                      f"{m['scheme']:10s} {m['measured_imbalance']:9.3f} "
                      f"{m['nnz_imbalance']:9.3f}", file=out)
    if ledger:
        print("  retrace ledger:", file=out)
        for r in ledger:
            for k, v in sorted(r.items()):
                if k in ("name", "section"):
                    continue
                print(f"    {k}: {v}", file=out)
    for r in rows:
        if isinstance(r, dict) and any(
                isinstance(r.get(k), dict)
                for k in ("dispatch", "streams", "queue", "health")):
            render_snapshot(r, out=out, label=_row_label(r))


def _row_label(row: dict) -> str:
    for key in ("name", "dataset", "stream"):
        v = row.get(key)
        if isinstance(v, str) and v:
            return v
    return "snapshot"


def render_snapshot(snap: dict, out=None, label: str = "snapshot") -> None:
    """Gauge tables from a ``ServiceMetrics.snapshot()``-shaped dict —
    pod/double-buffer dispatch, per-session streams, queue, and SLO
    health (whichever sub-dicts are present)."""
    out = out or sys.stdout
    disp = snap.get("dispatch")
    if isinstance(disp, dict) and disp:
        print(f"  {label}: dispatch gauges:", file=out)
        for k in ("count", "assembly_s", "execute_s", "overlap_s",
                  "overlap_fraction", "device_occupancy"):
            if k in disp:
                print(f"    {k}: {_num(disp[k])}", file=out)
        per_dev = disp.get("device_dispatches")
        if per_dev:
            devs = " ".join(f"d{d}:{n}" for d, n in sorted(per_dev.items()))
            print(f"    device_dispatches: {devs}", file=out)
    streams = snap.get("streams")
    if isinstance(streams, dict) and streams:
        print(f"  {label}: streaming sessions:", file=out)
        print(f"    {'session':16s} {'incr':>5} {'evict':>5} "
              f"{'p50_s':>9} {'p99_s':>9} {'merge_s':>9}", file=out)
        for sid, s in sorted(streams.items()):
            print(f"    {str(sid)[:16]:16s} {s.get('increments', 0):5d} "
                  f"{s.get('evictions', 0):5d} "
                  f"{_num(s.get('increment_p50_s')):>9} "
                  f"{_num(s.get('increment_p99_s')):>9} "
                  f"{_num(s.get('merge_s')):>9}", file=out)
    queue = snap.get("queue")
    if isinstance(queue, dict) and queue:
        print(f"  {label}: queue: depth={queue.get('depth')} "
              f"oldest_age_s={_num(queue.get('oldest_age_s'))} "
              f"peak_depth={queue.get('peak_depth')} "
              f"peak_age_s={_num(queue.get('peak_age_s'))}", file=out)
    health = snap.get("health")
    if isinstance(health, dict) and health:
        status = health.get("status", "?")
        print(f"  {label}: health: {status} "
              f"({health.get('checked', 0)} SLO(s) judged)", file=out)
        for b in health.get("breaches", []):
            print(f"    BREACH {b.get('slo')} [{b.get('scope')}]: "
                  f"observed {_num(b.get('observed'))} vs "
                  f"{b.get('kind')} {_num(b.get('target'))}", file=out)


# ---------------------------------------------------------------------------
# History trends
# ---------------------------------------------------------------------------


def render_history(records: list[dict], out=None, k: int = 8,
                   sections: list[str] | None = None) -> None:
    """Trend tables over the ledger: per section, each gated metric's
    last-k values (oldest → newest, one column per run, git sha header).
    Metrics no spec gates are omitted — the trend table answers "is the
    gate about to fire", not "dump everything"."""
    out = out or sys.stdout
    if not records:
        print("  (empty history)", file=out)
        return
    secs = sections or sorted({r["section"] for r in records})
    for sec in secs:
        recs = obs_history.tail(records, sec, k)
        if not recs:
            continue
        labels = [r["git_sha"][:7] + ("*" if r.get("git_dirty") else "")
                  for r in recs]
        series = [obs_history.row_metrics(r.get("rows", [])) for r in recs]
        print(f"-- {sec} ({len(recs)} run(s), oldest -> newest) --",
              file=out)
        print(f"  {'metric':44s} " + " ".join(f"{l:>9}" for l in labels),
              file=out)
        names: list[str] = []
        for s in series:
            for name in s:
                if name not in names:
                    names.append(name)
        shown = 0
        for rname in names:
            metrics: list[str] = []
            for s in series:
                for m in s.get(rname, {}):
                    if m not in metrics:
                        metrics.append(m)
            for metric in metrics:
                spec = obs_regress.classify(metric)
                if spec is None:
                    continue
                vals = [s.get(rname, {}).get(metric) for s in series]
                arrow = "^" if spec.direction == "up" else "v"
                cells = " ".join(f"{_num(v):>9}" for v in vals)
                print(f"  {arrow} {rname + ':' + metric:42s} {cells}",
                      file=out)
                shown += 1
        if not shown:
            print("  (no gated metrics in this section's rows)", file=out)


def _num(x) -> str:
    if x is None:
        return "-"
    if isinstance(x, bool):
        return str(x)
    if isinstance(x, (int, float)):
        return f"{x:.4g}"
    return str(x)


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------


def _load(path: str):
    """('trace', spans, events) or ('bench', doc) by sniffing the file.
    A whole-file JSON parse distinguishes single-document exports; a
    failure means JSONL (one record per line, meta first)."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        records = [json.loads(line) for line in text.splitlines()
                   if line.strip()]
        spans, events = _normalize(records)
        return ("trace", spans, events)
    if isinstance(doc, dict) and "traceEvents" in doc:
        obs_trace.validate_chrome(doc)
        spans, events = _normalize(doc["traceEvents"])
        return ("trace", spans, events)
    return ("bench", doc)


_DEFAULT_HISTORY = "results/BENCH_torch_history.jsonl"


def main(argv: list[str] | None = None, out=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = out or sys.stdout
    history_path = None
    if "--history" in argv:
        i = argv.index("--history")
        argv.pop(i)
        # optional path operand; default is the repo ledger
        if i < len(argv) and not argv[i].startswith("-") \
                and argv[i].endswith(".jsonl"):
            history_path = argv.pop(i)
        else:
            history_path = _DEFAULT_HISTORY
    if "-h" in argv or "--help" in argv or (not argv and not history_path):
        print("usage: python -m repro_torch.obs.report [--history [LEDGER]] "
              "TRACE_OR_BENCH_FILE...", file=out)
        print(__doc__, file=out)
        return 0 if (argv or history_path) else 2
    if history_path is not None:
        print(f"== {history_path} ==", file=out)
        try:
            records = obs_history.load(history_path, strict=False)
        except OSError as exc:
            print(f"  (cannot read ledger: {exc})", file=out)
            return 1
        render_history(records, out=out)
    for path in argv:
        kind, *rest = _load(path)
        print(f"== {path} ==", file=out)
        if kind == "trace":
            spans, events = rest
            print("-- span tree --", file=out)
            render_tree(spans, out=out)
            print("-- compile/retrace ledger --", file=out)
            render_ledger(events, out=out)
        else:
            (doc,) = rest
            print("-- calibration --", file=out)
            render_bench(doc, out=out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
