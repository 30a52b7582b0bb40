"""Port vs JAX package: the span recorder and serving SLO health.

``repro_torch.obs.trace`` and ``obs.health`` are copies of the
reference's pure-Python modules.  The same scripted span trees give
records of the same shape and nesting in both; the same scripted gauge
views give the same health reports and the same edge-triggered
``health.breach`` / ``health.clear`` events, bitwise.  The service's
``serve.flush`` spans and ``plan.build`` events are checked on the
port's own service on the CPU.
"""
import gc
import json
import sys

import numpy as np
import pytest

from repro.obs import health as r_health
from repro.obs import trace as r_trace
from repro_torch.core import plan as plan_mod
from repro_torch.core.coo import random_sparse
from repro_torch.obs import health, trace
from repro_torch.serve import DecompositionService, ServiceMetrics

SHAPE = (12, 9, 7)


@pytest.fixture(autouse=True)
def _port_tracer_off():
    yield
    trace.disable()


def _random_tree(rng, depth=0):
    n_kids = int(rng.integers(0, 4 - depth)) if depth < 3 else 0
    return [_random_tree(rng, depth + 1) for _ in range(n_kids)]


def _run_tree(tr, tree, path="r"):
    with tr.span(f"n.{path}", cat="t", depth=len(path)) as sp:
        tr.event(f"e.{path}", cat="t", kids=len(tree))
        for i, sub in enumerate(tree):
            _run_tree(tr, sub, f"{path}.{i}")
        sp.set(done=True)


def _shape_of(records):
    """What must agree between the two recorders: kind, name, category,
    args and the parent's name, per record in order."""
    names = {r["id"]: r["name"] for r in records}
    return [(r["kind"], r["name"], r["cat"], json.dumps(r["args"], sort_keys=True),
             names.get(r["parent"])) for r in records]


@pytest.mark.parametrize("seed", range(6))
def test_span_trees_match_reference(seed):
    rng = np.random.default_rng(seed)
    trees = [_random_tree(rng) for _ in range(int(rng.integers(1, 4)))]
    ours, ref = trace.Tracer("t"), r_trace.Tracer("t")
    for i, t in enumerate(trees):
        _run_tree(ours, t, f"r{i}")
        _run_tree(ref, t, f"r{i}")
    assert _shape_of(ours.records()) == _shape_of(ref.records())
    assert set(ours.records()[0]) == set(ref.records()[0])
    doc = json.loads(json.dumps(ours.to_chrome()))
    events = trace.validate_chrome(doc)
    assert sum(e["ph"] == "X" for e in events) == sum(
        r["kind"] == "span" for r in ours.records())
    r_trace.validate_chrome(doc)          # the reference's schema holds too


def test_jsonl_roundtrip(tmp_path):
    tr = trace.Tracer("rt")
    with tr.span("outer", cat="t", k=1):
        with tr.span("inner", cat="t") as sp:
            sp.set(n=np.int64(3), shape=(2, 3))
        tr.event("tick", cat="t", v=np.float32(0.5))
    path = tmp_path / "t.jsonl"
    tr.dump_jsonl(str(path))
    back = trace.load_jsonl(str(path))
    assert [r["name"] for r in back] == ["inner", "tick", "outer"]
    assert back[0]["args"] == {"n": 3, "shape": [2, 3]}
    assert back[0]["parent"] == back[2]["id"]
    tr.dump_chrome(str(tmp_path / "t.json"))
    trace.validate_chrome(json.loads((tmp_path / "t.json").read_text()))


def test_capture_restores_previous_tracer():
    outer = trace.enable()
    with trace.capture("inner") as tr:
        assert trace.active() is tr
        trace.event("x")
    assert trace.active() is outer
    assert [r["name"] for r in tr.records()] == ["x"]
    assert trace.disable() is outer and trace.active() is None


def test_null_span_and_disabled_event():
    assert trace.active() is None
    sp = trace.span("off", k=1)
    assert sp is trace.NULL
    with sp as s:
        assert s.set(a=2) is s
    trace.event("dropped")                 # no tracer: nothing to record


@pytest.mark.parametrize("guard", [trace.active, trace.sink])
def test_disabled_window_guard_allocates_nothing(guard):
    """Neither guard allocates with tracing off; ``sink`` adds the
    profiler check to ``active``'s global read."""
    def guarded():
        tr = guard()
        with (trace.NULL if tr is None else tr.span("w")):
            pass

    for _ in range(100):
        guarded()
    gc.collect()
    gc.disable()
    try:
        before = sys.getallocatedblocks()
        for _ in range(10_000):
            guarded()
        after = sys.getallocatedblocks()
    finally:
        gc.enable()
    assert after - before <= 8


def test_validate_chrome_rejects_bad_docs():
    for bad in ({}, {"traceEvents": 1}, {"traceEvents": [{"ph": "X"}]},
                {"traceEvents": [{"name": "a", "ph": "Q", "pid": 0, "tid": 0}]},
                {"traceEvents": [{"name": "a", "ph": "X", "pid": 0, "tid": 0,
                                  "ts": 0, "dur": -1}]}):
        with pytest.raises(ValueError):
            trace.validate_chrome(bad)


# -- health -------------------------------------------------------------------

POLICY = dict(latency_p99_s=0.5, bucket_latency_p99_s={"('a',)": 0.1},
              queue_depth=4, queue_age_s=1.0, cache_hit_rate_min=0.8,
              overlap_fraction_min=0.3, batch_occupancy_min=0.5,
              stream_increment_p99_s=0.2, min_events=2)


def _views(seed):
    """A scripted stream of gauge views: every SLO crosses its target up
    and down at seeded points."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        u = rng.uniform(0.0, 1.0, 9)
        out.append({
            "completed": i,
            "latency_p99_s": float(u[0]),
            "bucket_latency_p99_s": {"('a',)": float(u[1] * 0.2),
                                     "('b',)": float(u[2])},
            "queue": {"depth": int(u[3] * 8), "oldest_age_s": float(u[4] * 2)},
            "cache_hit_rate": float(u[5]),
            "batch_occupancy": float(u[6]),
            "dispatch": {"count": i, "overlap_fraction": float(u[7])},
            "streams": {"s0": {"increments": i % 3,
                               "increment_p99_s": float(u[8] * 0.4)}},
        })
    return out


@pytest.mark.parametrize("seed", range(4))
def test_health_reports_and_breach_events_match_reference(seed):
    ours = health.HealthMonitor(health.SLOPolicy(**POLICY))
    ref = r_health.HealthMonitor(r_health.SLOPolicy(**POLICY))
    with trace.capture() as tr, r_trace.capture() as rtr:
        for view in _views(seed):
            assert ours.observe(view) == ref.observe(view)
    ev = [(r["name"], r["args"]) for r in tr.records()]
    rev = [(r["name"], r["args"]) for r in rtr.records()]
    assert ev == rev
    assert any(name == "health.breach" for name, _ in ev)
    assert any(name == "health.clear" for name, _ in ev)


@pytest.mark.parametrize("view", [
    {"completed": 100, "latency_p99_s": 99.0},
    {"completed": 0, "latency_p99_s": 9.0, "queue": {"depth": 9}},
    {"completed": 1, "cache_hit_rate": 0.0, "batch_occupancy": 0.0},
])
def test_evaluate_matches_reference(view):
    for pol in ({}, POLICY):
        assert health.evaluate(health.SLOPolicy(**pol), view) == \
            r_health.evaluate(r_health.SLOPolicy(**pol), view)


def test_metrics_snapshot_carries_health():
    m = ServiceMetrics(slo=health.SLOPolicy(queue_depth=1))
    assert m.snapshot()["health"]["status"] == "ok"
    m.record_queue(5, 0.0)
    with trace.capture() as tr:
        rep = m.snapshot()["health"]
    assert rep["status"] == "breach"
    assert [r["name"] for r in tr.records()] == ["health.breach"]
    assert ServiceMetrics().snapshot()["health"]["status"] == "disabled"


# -- the service's own spans and events ------------------------------------------


def test_service_flush_spans_and_plan_events():
    plan_mod.plan_bucket.cache_clear()
    svc = DecompositionService(3, max_batch=2, check_every=2, device="cpu")
    ts = [random_sparse(SHAPE, 90 + i, seed=i) for i in range(4)]
    with trace.capture() as tr:
        for t in ts:
            svc.submit(t, n_iters=2, tol=-1.0)
        svc.drain()
    recs = tr.records()
    flushes = [r for r in recs if r["name"] == "serve.flush"]
    assert [f["args"]["trigger"] for f in flushes] == ["max_batch", "max_batch"]
    snap = svc.snapshot()
    assert sum(f["args"]["cache_misses"] for f in flushes) == snap["cache_misses"]
    assert sum(f["args"]["cache_hits"] for f in flushes) == snap["cache_hits"]
    plans = [r for r in recs if r["name"] == "plan.build"]
    # first flush: uniform prior; second: the first flush's density
    assert [p["args"]["observed_density"] for p in plans] == [False, True]
    windows = [r for r in recs if r["name"] == "batched.window"]
    assert len(windows) == 2 and all(w["parent"] in
                                     {f["id"] for f in flushes} for w in windows)
