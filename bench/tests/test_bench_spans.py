"""The readers of the program's own spans and upload counter, on the tiny
cell on the CPU: the device metrics are left out there, the counter is
exact, the host spans are read once and cached on the run."""
import importlib
import time
import types

import numpy as np
import pytest

from bench.harness import cell as cell_mod
from bench.harness import spans
from bench.harness.spec import metric_reader
from bench.tests.tiny import tiny_cell

READERS = ("fit_span_ms", "mttkrp_span_ms", "front_door_ms",
           "h2d_mb_per_call", "plan_layout_s", "plan_pack_s")


@pytest.fixture(scope="module")
def run():
    cell = tiny_cell()
    cfg = cell.config
    r = cell_mod.Run(cell=cell, seed=2 ** 31 + 5, seconds=0.2, trace=False,
                     device=cell_mod.torch.device("cpu"),
                     shape=tuple(cfg["shape"]), nnz=cfg["nnz"],
                     rank=cfg["rank"])
    _, _, client = cell_mod.setup(r, time.perf_counter())
    cell_mod.window(r, client)
    return r


def test_device_metrics_are_left_out_on_the_cpu(run):
    assert metric_reader("fit_span_ms")(run) is None
    assert metric_reader("mttkrp_span_ms")(run) is None


def test_h2d_mb_per_call_is_exact(run):
    R, shape = run.rank, run.shape
    state = (sum(shape) * R + len(shape) * R * R + R) * 4
    fit = run.nnz * (4 * len(shape) + 4) + 4      # int32 indices, values, norm
    assert run.tensor.indices.dtype == np.int32
    assert metric_reader("h2d_mb_per_call")(run) == (state + fit) / 1e6


def test_host_spans_are_read_once(run):
    front = metric_reader("front_door_ms")(run)
    layout = metric_reader("plan_layout_s")(run)
    pack = metric_reader("plan_pack_s")(run)
    assert front > 0 and layout > 0 and pack > 0
    s = spans.read(run)
    assert spans.read(run) is s
    calls = run.cell.traffic["traced_calls"]
    n_iters = run.cell.traffic["n_iters"]
    windows = n_iters // run.cell.traffic["check_every"]
    assert s.count["cpd.call"] == s.count["cpd.prepare"] == calls
    assert s.count["als.window"] == calls * windows
    assert s.count["als.fit"] == s.sweeps == calls * n_iters
    assert s.count["als.mttkrp"] == len(run.shape) * s.sweeps
    assert s.device_s is None
    assert set(s.plan_s) == {"plan.layouts", "plan.pack"}


def test_a_program_without_spans_gives_nothing(run, monkeypatch):
    """A program without the spans and the counter: every reader is left
    out and none raises."""
    trace = importlib.import_module("repro_torch.obs.trace")
    monkeypatch.setattr(trace, "_profiler_record", lambda name: None)
    monkeypatch.setattr(trace, "_ACTIVE", None)
    monkeypatch.delattr(run, spans._CACHE, raising=False)
    for c in run.calls:
        fields = {k: v for k, v in vars(c.result).items() if k != "h2d_bytes"}
        monkeypatch.setattr(c, "result", types.SimpleNamespace(**fields))
    try:
        for name in READERS:
            assert metric_reader(name)(run) is None, name
    finally:
        monkeypatch.undo()
        # Drop the empty sums so later readers measure again.
        if hasattr(run, spans._CACHE):
            delattr(run, spans._CACHE)
