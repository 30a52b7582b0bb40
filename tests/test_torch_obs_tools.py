"""Port vs JAX package: the perf tools (history, regress, report), the build
ledger and calibration, on the CPU.

``repro_torch.obs.history`` / ``regress`` / ``report`` are copies of the
reference's: the same records (or files) go through both and give equal
records, findings, baselines, return codes and rendered text.  The cases
mirror ``tests/obs/test_history.py``, ``test_regress.py`` and
``test_calibrate_report.py`` (the reference's hypothesis properties as
seeded cases).  The port's build ledger counts builds of its window
functions, not XLA traces: a novel shape adds one, a repeat adds none,
and it agrees with the window caches' misses.  ``calibrate_tensor`` rows
carry the reference's keys with finite values; the tile-model fit
recovers known constants.
"""
import dataclasses
import io
import json

import numpy as np
import pytest

from repro.core import random_sparse as r_random_sparse
from repro.obs import calibrate as r_calibrate
from repro.obs import history as r_history
from repro.obs import regress as r_regress
from repro.obs import report as r_report
from repro.obs import trace as r_trace
from repro_torch.core import als_device
from repro_torch.core.coo import random_sparse
from repro_torch.core.cpd import cpd_als
from repro_torch.core.layout import build_mode_layout
from repro_torch.kernels import ops as kops
from repro_torch.obs import LEDGER, RetraceLedger
from repro_torch.obs import calibrate, history, regress, report
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import BatchedEngine
from repro_torch.serve.batched_engine import batched_cache_stats

PROV = {"ts_utc": "2026-08-08T00:00:00Z", "git_sha": "a" * 40,
        "git_dirty": False, "host": "ci", "jax_version": "0.4",
        "device": "cpu"}


def _record(mod, section="serve", rows=None, smoke=True, wall_s=1.5):
    return mod.make_record(
        section, rows=rows if rows is not None else [{"name": "r0",
                                                      "speedup": 2.0}],
        wall_s=wall_s, config={"argv": [], "smoke": smoke}, provenance=PROV)


def _both(fn):
    """``fn(module)`` on the reference's module and the port's."""
    return fn(r_history), fn(history)


# -- history ---------------------------------------------------------------


def test_make_record_equal():
    ref, port = _both(_record)
    assert ref == port
    assert port["schema"] == history.SCHEMA_VERSION == r_history.SCHEMA_VERSION


def _drop(key):
    def edit(rec):
        del rec[key]
    return edit


def _set(key, value):
    def edit(rec):
        rec[key] = value
    return edit


@pytest.mark.parametrize("edit,match", [
    (_drop("git_sha"), "git_sha"),
    (_set("wall_s", "fast"), "wall_s"),
    (_set("schema", 99), "schema 99"),
    (_set("rows", [{"ok": 1}, "not-a-dict"]), r"rows\[1\]"),
    (lambda rec: rec.clear(), "schema"),
], ids=["missing", "type", "schema", "row", "empty"])
def test_validate_names_first_violation(edit, match):
    messages = []
    for mod in (r_history, history):
        rec = _record(mod)
        edit(rec)
        with pytest.raises(ValueError, match=match) as exc:
            mod.validate_record(rec)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("writer,reader", [(history, r_history), (r_history, history)],
                         ids=["port_writes", "reference_writes"])
def test_append_load_roundtrip(tmp_path, writer, reader):
    path = tmp_path / "hist.jsonl"
    recs = [_record(writer, section=s, wall_s=float(i))
            for i, s in enumerate(("serve", "obs", "serve"))]
    for r in recs:
        writer.append(path, r)
    assert reader.load(path) == recs
    with open(path, "a") as f:
        f.write("{not json\n")
    with pytest.raises(ValueError, match=r"hist\.jsonl:4"):
        reader.load(path)
    assert len(reader.load(path, strict=False)) == 3
    assert reader.tail(recs, "serve", 1) == [recs[2]]


def test_row_metrics_and_fingerprints_equal():
    rows = [
        {"name": "s0", "speedup": 2.5, "ok": True, "plan": "m0:t512",
         "bad": float("nan"), "dispatch": {"count": 3, "overlap_fraction":
                                           0.5, "nested": {"deep": 1}},
         "listy": [1, 2]},
        {"dataset": "uber", "measured_s": 0.5},
        {"stream": "sess-1", "increment_p99_s": 0.01},
        {"unnamed": 1.0}, {"plan": "m0:t256"}, {"plan": 7},
    ]
    ref, port = _both(lambda m: (m.row_metrics(rows), m.plan_fingerprints(rows)))
    assert ref == port
    assert port[1] == ["m0:t256", "m0:t512"]


@pytest.mark.parametrize("argv", [["validate", "{path}"], ["validate"], []],
                         ids=["valid_then_broken", "no_path", "no_args"])
def test_history_cli_equal(tmp_path, capsys, argv):
    path = tmp_path / "hist.jsonl"
    history.append(path, _record(history))
    args = [a.format(path=path) for a in argv]
    outs = []
    for mod in (r_history, history):
        rcs = [mod.main(list(args))]
        if args[1:]:
            with open(path) as f:
                good = f.read()
            with open(path, "a") as f:
                f.write(json.dumps({"schema": 1}) + "\n")
            rcs.append(mod.main(list(args)))
            path.write_text(good)
        captured = capsys.readouterr()
        outs.append((rcs, captured.out, captured.err.replace("repro_torch", "repro")))
    assert outs[0] == outs[1]


# -- regress ---------------------------------------------------------------


@pytest.mark.parametrize("metric", [
    "latency_p99_s", "cache_hit_rate", "speedup", "padding_overhead",
    "imbalance_contiguous", "host_syncs", "dispatch.overlap_fraction",
    "queue.oldest_age_s", "bat_rps", "sweep_traces", "max_abs_err",
    "fit_gap", "requests", "plan"])
def test_classify_equal(metric):
    ref, port = r_regress.classify(metric), regress.classify(metric)
    assert (ref is None) == (port is None)
    if port is not None:
        assert dataclasses.asdict(ref) == dataclasses.asdict(port)


def test_best_and_spread_equal():
    for mod in (r_regress, regress):
        assert mod.best([3.0, 1.0, 2.0], "down") == 1.0
        assert mod.best([3.0, 1.0, 2.0], "up") == 3.0
        with pytest.raises(ValueError):
            mod.best([], "down")
    assert regress.rel_spread([1.0, 1.1]) == r_regress.rel_spread([1.0, 1.1])
    assert regress.MAX_REL_TOL == r_regress.MAX_REL_TOL


def _records(mod, values, section="serve", metric="latency_p99_s", row="s0"):
    return [mod.make_record(section, rows=[{"name": row, metric: float(v)}],
                            wall_s=1.0, config={"argv": [], "smoke": True},
                            provenance=PROV) for v in values]


def _gate(mod, base_values, fresh_values, metric="latency_p99_s", **kw):
    hist = r_history if mod is r_regress else history
    base = mod.baseline_from_history(_records(hist, base_values, metric=metric),
                                     ["serve"], repeats=len(base_values))
    findings = mod.compare_sections(base, _records(hist, fresh_values, metric=metric),
                                    ["serve"], repeats=len(fresh_values), **kw)
    return base, [dataclasses.asdict(f) for f in findings]


def _jitter(seed):
    rng = np.random.default_rng(seed)
    return list(1.0 + 0.02 * rng.random(3)), list(1.0 + 0.02 * rng.random(3))


GATES = {
    "jitter_seed0": (*_jitter(0), "latency_p99_s", {}),
    "jitter_seed7": (*_jitter(7), "latency_p99_s", {}),
    "outlier": ([1.0, 1.0], [5.0, 1.01, 1.0], "latency_p99_s", {}),
    "noisy_baseline": ([3.54, 1.84], [1.84, 1.86], "speedup", {}),
    "past_envelope": ([3.54, 1.84], [0.60, 0.61], "speedup", {}),
    "slowdown_2x": ([1.0, 1.02, 0.99], [2.0, 2.04, 1.98], "latency_p99_s", {}),
    "slowdown_2x_noise": ([1.0], [2.0, 2.6], "latency_p99_s", {"noise_mult": 1e6}),
    "improved": ([1.0], [0.4], "latency_p99_s", {}),
    "hit_rate_drop": ([0.9], [0.36], "cache_hit_rate", {}),
    "hit_rate_rise": ([0.5], [0.9], "cache_hit_rate", {}),
    "portable_timing": ([1.0], [3.0], "latency_p99_s", {"portable_only": True}),
    "portable_ratio": ([0.9], [0.2], "cache_hit_rate", {"portable_only": True}),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_compare_sections_equal(case):
    base_vals, fresh_vals, metric, kw = GATES[case]
    ref = _gate(r_regress, base_vals, fresh_vals, metric, **kw)
    port = _gate(regress, base_vals, fresh_vals, metric, **kw)
    assert ref == port
    (f,) = [f for f in port[1] if f["metric"] == metric]
    expected = {"outlier": "ok", "noisy_baseline": "ok", "past_envelope": "regression",
                "slowdown_2x": "regression", "slowdown_2x_noise": "regression",
                "improved": "improved", "hit_rate_drop": "regression",
                "hit_rate_rise": "improved", "portable_timing": "info",
                "portable_ratio": "regression"}.get(case, ("ok", "improved"))
    assert f["status"] in (expected if isinstance(expected, tuple) else (expected,))


@pytest.mark.parametrize("case", ["missing_section", "vanished_metric", "new_metric"])
def test_missing_and_new_metrics_equal(case):
    out = []
    for mod, hist in ((r_regress, r_history), (regress, history)):
        base = mod.baseline_from_history(_records(hist, [1.0]), ["serve"], repeats=1)
        if case == "missing_section":
            fresh = []
        elif case == "vanished_metric":
            fresh = _records(hist, [1.0], metric="other_metric_s")
        else:
            fresh = [hist.make_record(
                "serve", rows=[{"name": "s0", "latency_p99_s": 1.0,
                                "brand_new_s": 5.0}], wall_s=1.0,
                config={"argv": [], "smoke": True}, provenance=PROV)]
        out.append([dataclasses.asdict(f)
                    for f in mod.compare_sections(base, fresh, ["serve"], repeats=1)])
    assert out[0] == out[1]
    statuses = {f["metric"]: f["status"] for f in out[1]}
    assert "missing" in statuses.values() or statuses.get("brand_new_s") == "new"


@pytest.mark.parametrize("fresh", [[1.0, 1.01], [2.0, 2.02]], ids=["clean", "slowdown"])
def test_regress_cli_equal(tmp_path, capsys, fresh):
    results = []
    for mod, hist, tag in ((r_regress, r_history, "r"), (regress, history, "t")):
        path = tmp_path / f"{tag}_hist.jsonl"
        base = tmp_path / f"{tag}_base.json"
        for r in _records(hist, [1.0, 1.01]):
            hist.append(path, r)
        common = ["--history", str(path), "--baseline", str(base),
                  "--sections", "serve", "--repeats", "2"]
        rc_update = mod.main(common + ["--update-baseline"])
        for r in _records(hist, fresh):
            hist.append(path, r)
        rc_check = mod.main(common + ["--check"])
        out = capsys.readouterr().out.replace(str(tmp_path / tag), "X")
        results.append((rc_update, rc_check, json.loads(base.read_text()), out))
        with pytest.raises(SystemExit):
            mod.main(common)
        capsys.readouterr()
    assert results[0] == results[1]
    assert results[1][1] == (0 if fresh[0] < 1.5 else 1)


# -- report ----------------------------------------------------------------


def _sample_tracer():
    tr = obs_trace.Tracer("rep")
    with tr.span("outer", cat="t"):
        tr.event("ledger.compile", cat="compile", kind="sweep_block",
                 key="(k)")
        with tr.span("inner", cat="t"):
            pass
        with tr.span("inner", cat="t"):
            pass
    return tr


def test_aggregate_tree_equal():
    spans = [r for r in _sample_tracer().records() if r["kind"] == "span"]
    assert report.aggregate_tree(spans) == r_report.aggregate_tree(spans)


BENCH_ROWS = [
    {"name": "obs/x/slab", "section": "ratio", "dataset": "x",
     "backend": "slab", "predicted_s": 1e-3, "measured_s": 2e-3,
     "predicted_over_observed": 0.5, "compile_overhead_s": 0.1,
     "steady_window_s": 0.01},
    {"name": "obs/x/imbalance", "section": "imbalance", "dataset": "x",
     "per_mode": [{"mode": 0, "scheme": "NNZ_PARTITION",
                   "measured_imbalance": 1.2, "nnz_imbalance": 1.0}]},
    {"name": "obs/ledger", "section": "ledger", "blocks": 3,
     "traces": 3, "expected_max_traces": 3},
    {"name": "svc", "dispatch": {"count": 2, "overlap_s": 0.5,
                                 "overlap_fraction": 0.1},
     "streams": {"s": {"increments": 2, "evictions": 0,
                       "increment_p50_s": 1.0, "increment_p99_s": 2.0,
                       "merge_s": 0.3}},
     "queue": {"depth": 0, "oldest_age_s": 0.0, "peak_depth": 8,
               "peak_age_s": 1.5},
     "health": {"status": "ok", "checked": 2, "breaches": []}},
]


@pytest.mark.parametrize("kind", ["jsonl", "chrome", "bench", "history", "help"])
def test_report_main_equal(tmp_path, kind):
    tr = _sample_tracer()
    if kind == "jsonl":
        path = tmp_path / "t.jsonl"
        tr.dump_jsonl(path)
        argv = [str(path)]
    elif kind == "chrome":
        path = tmp_path / "t.trace.json"
        tr.dump_chrome(str(path))
        argv = [str(path)]
    elif kind == "bench":
        path = tmp_path / "BENCH_obs.json"
        path.write_text(json.dumps({"rows": BENCH_ROWS}))
        argv = [str(path)]
    elif kind == "history":
        path = tmp_path / "h.jsonl"
        for v in (1.0, 1.1, 0.9):
            history.append(path, _records(history, [v])[0])
        argv = ["--history", str(path)]
    else:
        argv = []
    texts = []
    for mod in (r_report, report):
        out = io.StringIO()
        rc = mod.main(list(argv), out=out)
        texts.append((rc, out.getvalue()))
    if kind == "help":
        # The usage line and docstring name each package's own module.
        assert texts[0][0] == texts[1][0] == 2
        assert "usage: python -m repro_torch.obs.report" in texts[1][1]
    else:
        assert texts[0] == texts[1]
        assert texts[1][0] == 0


# -- the build ledger ------------------------------------------------------


def test_ledger_counts_builds_and_rebaselines():
    led = RetraceLedger()
    fn = object()
    assert led.register("k", ("a", 1), fn) is fn
    assert led.stats("k") == {"blocks": 1, "blocks_new": 1, "traces": 1}
    led.reset()
    assert led.stats("k") == {"blocks": 1, "blocks_new": 0, "traces": 0}
    led.register("k", ("a", 1), fn)          # the same key built again
    led.register("k", ("b", 2), fn)
    assert led.stats("k") == {"blocks": 2, "blocks_new": 2, "traces": 2}
    assert led.entries("k") == [{"kind": "k", "key": "('a', 1)", "traces": 1},
                                {"kind": "k", "key": "('b', 2)", "traces": 1}]
    with led.isolated():
        assert led.stats()["traces"] == 0
        led.register("j", "x", fn)
        assert led.stats()["traces"] == 1 and led.kinds() == ["j", "k"]
    assert led.stats()["traces"] == 0


def test_registration_emits_compile_event():
    with obs_trace.capture() as tr:
        RetraceLedger().register("demo", ("t", 1), object())
    (ev,) = tr.records()
    assert ev["kind"] == "event" and ev["name"] == "ledger.compile"
    assert ev["args"] == {"kind": "demo", "key": "('t', 1)"}


@pytest.mark.parametrize("backend", ["slab", "segment"])
def test_sweep_builds_novel_shape_adds_one_repeat_adds_none(backend):
    shape = (13, 9, 7) if backend == "slab" else (13, 9, 6)
    t = random_sparse(shape, 150, seed=3)
    kw = dict(n_iters=4, check_every=2, backend=backend, device="cpu")
    with LEDGER.isolated():
        s0, c0 = als_device.sweep_trace_stats(), als_device.sweep_cache_stats()
        cpd_als(t, 3, **kw)
        s1, c1 = als_device.sweep_trace_stats(), als_device.sweep_cache_stats()
        cpd_als(t, 3, **kw)
        s2, c2 = als_device.sweep_trace_stats(), als_device.sweep_cache_stats()
    assert s1["traces"] - s0["traces"] == 1 == c1["misses"] - c0["misses"]
    assert s1["blocks"] - s0["blocks"] == 1
    assert s2 == s1 and c2["misses"] == c1["misses"]


def test_batched_builds_agree_with_cache_misses():
    shape = (11, 8, 5)
    ts = [random_sparse(shape, 90 - 3 * b, seed=b) for b in range(3)]
    eng = BatchedEngine(2, check_every=2, device="cpu")
    with LEDGER.isolated():
        before = batched_cache_stats()
        eng.decompose_batch(ts, n_iters=4, nnz_cap=96)
        mid = LEDGER.stats("batched_block")
        eng.decompose_batch(ts, n_iters=4, nnz_cap=96)
        after = LEDGER.stats("batched_block")
        misses = batched_cache_stats()["misses"] - before["misses"]
    assert mid["traces"] == misses >= 1
    assert after["traces"] == mid["traces"]


# -- calibration -----------------------------------------------------------


SHAPE = (12, 9, 7)


def test_calibrate_tensor_rows_have_the_reference_keys():
    kw = dict(rank=3, predict_fn=lambda t, d, b: 1e-6, kappa=4, reps=1,
              imbalance_reps=2)
    with obs_trace.capture() as tr:
        rows = calibrate.calibrate_tensor(
            "tiny", random_sparse(SHAPE, 120, seed=5), backends=("slab",),
            device="cpu", **kw)
    with r_trace.capture():
        ref = r_calibrate.calibrate_tensor(
            "tiny", r_random_sparse(SHAPE, 120, seed=5), backends=("segment",),
            **kw)
    assert [r["section"] for r in rows] == [r["section"] for r in ref]
    for got, want in zip(rows, ref):
        assert set(got) == set(want)
        for g, w in zip(got["per_mode"], want["per_mode"]):
            assert set(g) == set(w)
    ratio, imb = rows
    assert ratio["backend"] == "slab" and ratio["measured_s"] > 0.0
    assert ratio["predicted_s"] == pytest.approx(3e-6)
    assert np.isfinite([ratio["predicted_over_observed"], ratio["cold_window_s"],
                        ratio["steady_window_s"], ratio["compile_overhead_s"]]).all()
    assert all(m["measured_s"] > 0.0 and np.isfinite(m["ratio"])
               for m in ratio["per_mode"])
    # The imbalance table is host numpy on the same layouts: the shard
    # sizes and the partitioner's prediction equal the reference's.
    for g, w in zip(imb["per_mode"], ref[1]["per_mode"]):
        assert g["shard_nnz"] == w["shard_nnz"] and g["scheme"] == w["scheme"]
        assert g["nnz_imbalance"] == w["nnz_imbalance"]
        assert np.isfinite(g["measured_imbalance"])
    names = {r["name"] for r in tr.records() if r["kind"] == "span"}
    assert {"calibrate.mode_mttkrp", "calibrate.imbalance", "als.window"} <= names


def test_measure_compile_steady_requires_tracer():
    with pytest.raises(RuntimeError, match="active tracer"):
        calibrate.measure_compile_steady(random_sparse(SHAPE, 120, seed=5), 2,
                                         "slab", device="cpu")


@pytest.mark.parametrize("backend", ["slab", "segment", "coo"])
def test_mode_seconds_without_tracer(backend):
    assert obs_trace.active() is None
    out = calibrate.measure_mode_seconds(random_sparse(SHAPE, 120, seed=5), 2,
                                         backend, reps=1, device="cpu")
    assert len(out) == 3 and all(s > 0 for s in out)


@pytest.mark.parametrize("bw,chunk_s", [(2.0e12, 3.0e-7), (9.0e11, 0.0), (4.0e12, 1.0e-6)])
def test_fit_pack_cost_recovers_the_constants(bw, chunk_s):
    t = random_sparse((300, 40, 50), 20_000, seed=1, distribution="powerlaw")
    lay = build_mode_layout(t, 0, 1)
    rows = []
    for br, tile in kops.tile_candidates():
        c = kops.estimate_pack_cost(lay, br, tile, 16)
        rows.append({**c, "measured_s": c["bytes"] / bw
                     + c["chunks"] * c["num_rank_blocks"] * chunk_s})
    fit = calibrate.fit_pack_cost(rows)
    assert fit["bytes_per_s"] == pytest.approx(bw, rel=1e-6)
    assert fit["chunk_s"] == pytest.approx(chunk_s, rel=1e-6, abs=1e-15)


def test_measure_pack_candidates_on_the_cpu():
    t = random_sparse((60, 9, 8), 900, seed=2, distribution="powerlaw")
    lay = build_mode_layout(t, 0, 1)
    cands = [(8, 64), (128, 256)]
    with obs_trace.capture() as tr:
        rows = calibrate.measure_pack_candidates(lay, 4, cands, reps=2, device="cpu")
    assert [(r["block_rows"], r["tile"]) for r in rows] == cands
    for r in rows:
        assert r["slabs"] == r["grid"] and r["measured_s"] > 0 and r["smem_ok"]
    spans = [r for r in tr.records() if r["name"] == "calibrate.tile"]
    assert len(spans) == 2
