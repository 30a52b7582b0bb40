"""A configuration, a traffic mix, a metric and a cell's limits added as
new files only are found by name."""
import json
import shutil

from bench.harness import cell as cell_mod
from bench.harness import spec
from bench.tests.tiny import TINY


def test_added_files_are_found_by_name(tmp_path):
    bench_dir = tmp_path / "bench"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.BENCH_DIR / "configs" / "frostt-uber-r32.json",
                bench_dir / "configs" / "toy-r4.json")
    (bench_dir / "traffic" / "short.json").write_text(json.dumps(
        {"n_iters": 5, "check_every": 1, "tol": 0.0, "warmup_calls": 1,
         "traced_calls": 2, "checked_calls": 3}))
    (bench_dir / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return len(run.calls) / run.window_s\n")
    (bench_dir / "limits" / "toy.short.json").write_text(
        json.dumps({"factor_gap": 1e-3, "fit_gap": 1e-6}))
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "toy-r4", "source": "x",
                             "file": "bench/configs/toy-r4.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy.short", "config": "toy-r4",
                               "traffic": "short", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy.short"]})
    cell = spec.find_cell("toy.short", bench, bench_dir)
    assert (cell.traffic["n_iters"], cell.traffic["check_every"]) == (5, 1)
    assert cell.config["shape"] == [183, 24, 1140, 1717]
    assert cell.limits == {"factor_gap": 1e-3, "fit_gap": 1e-6}
    names = [m["name"] for m in cell.end_to_end]
    assert names == ["setup_s", "sweep_ms", "peak_mem_gb", "calls_per_s"]
    read = spec.metric_reader("calls_per_s", bench_dir)

    class Run:
        calls = [1, 2, 3]
        window_s = 1.5
    assert read(Run()) == 2.0
    # The added cell runs through the whole harness (CPU, tiny size): its
    # calls are held to the reference from the starts the program was
    # handed, and its metric is in the line.
    cell.config = dict(cell.config, **TINY)
    line = cell_mod.run_cell(cell, 5, 0.3, False, device="cpu",
                             require_cards=False)
    assert line["correct"] is True and line["attempted"] >= 2
    assert line["metrics"]["calls_per_s"]["value"] > 0
    # The existing cells do not report the new cell's metric.
    old = spec.find_cell("chicago.restarts", bench, bench_dir=spec.BENCH_DIR)
    assert "calls_per_s" not in [m["name"] for m in old.end_to_end]


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = spec.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_per_layer_metrics_follow_their_workloads():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"], bench)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)
