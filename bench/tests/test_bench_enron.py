"""The cell ``enron.restarts`` and the planning metrics it adds: found by
name with its configuration and limits, run through the harness at a tiny
size on the CPU, and the readers of ``plan.sort`` and
``MTTKRPPlan.device_bytes`` reading what the program reports."""
import importlib
import time

import pytest

from bench.harness import cell as cell_mod
from bench.harness import spec
from bench.harness.spec import metric_reader
from bench.tests.tiny import TINY, tiny_cell

PLAN_METRICS = ("plan_sort_s", "plan_gb")


def test_enron_cell_is_found_with_its_files():
    bench = spec.load_benchmark()
    cell = spec.find_cell("enron.restarts", bench)
    coo = importlib.import_module("repro_torch.core.coo")
    shape, nnz = coo.FROSTT_SHAPES["enron"]
    assert tuple(cell.config["shape"]) == shape and cell.config["nnz"] == nnz
    assert cell.config["name"] == cell.workload["config"] == "frostt-enron-r32"
    assert cell.config["reduced"] == [] and cell.workload["chips"] == 1
    assert cell.traffic == spec.find_cell("chicago.restarts", bench).traffic
    assert set(cell.limits) == {"factor_gap", "fit_gap"}
    assert [m["name"] for m in cell.per_layer] == list(PLAN_METRICS)
    entry = next(c for c in bench["configs"] if c["name"] == "frostt-enron-r32")
    assert entry["source"] == cell.config["source"]
    for name in ("chicago.restarts", "uber.restarts"):
        per_layer = [m["name"] for m in spec.find_cell(name, bench).per_layer]
        assert set(PLAN_METRICS) <= set(per_layer)


@pytest.fixture(scope="module")
def run():
    cell = tiny_cell("enron.restarts")
    cfg = cell.config
    r = cell_mod.Run(cell=cell, seed=2 ** 33 + 11, seconds=0.2, trace=False,
                     device=cell_mod.torch.device("cpu"),
                     shape=tuple(cfg["shape"]), nnz=cfg["nnz"],
                     rank=cfg["rank"])
    _, _, client = cell_mod.setup(r, time.perf_counter())
    cell_mod.window(r, client)
    return r


def test_plan_gb_is_the_plans_counter(run):
    assert metric_reader("plan_gb")(run) == run.plan.device_bytes / 1e9
    packed = sum(t.nbytes for d in range(len(run.shape))
                 for t in run.plan.packed(d).slots.values())
    assert run.plan.device_bytes > packed


def test_plan_sort_s_reads_one_span_per_mode(run, monkeypatch):
    trace = importlib.import_module("repro_torch.obs.trace")
    spans = []
    real = trace.Tracer.records

    def records(self):
        out = real(self)
        spans.append([r for r in out if r["name"] == "plan.sort"])
        return out
    monkeypatch.setattr(trace.Tracer, "records", records)
    value = metric_reader("plan_sort_s")(run)
    assert [r["args"]["mode"] for r in spans[-1]] == list(range(len(run.shape)))
    assert value == sum(r["dur_us"] for r in spans[-1]) / 1e6 > 0


def test_a_program_without_the_span_or_counter_gives_nothing(run, monkeypatch):
    lb = importlib.import_module("repro_torch.core.load_balance")
    monkeypatch.setattr(lb.obs_trace, "span",
                        lambda *a, **k: lb.obs_trace.NULL)
    assert metric_reader("plan_sort_s")(run) is None
    monkeypatch.setattr(run, "plan", object())
    assert metric_reader("plan_gb")(run) is None


def test_the_enron_cell_runs_through_the_harness():
    """The untraced line (a traced one needs the card's profiler)."""
    cell = tiny_cell("enron.restarts")
    assert cell.config["shape"] == TINY["shape"]
    line = cell_mod.run_cell(cell, 2 ** 31 + 3, 0.3, False, device="cpu",
                             require_cards=False)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "sweep_ms"}  # no card: no peak
