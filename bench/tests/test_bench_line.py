"""The result line: its keys, the comparisons printed last, and the runs
that print no result at all."""
import json
import shutil
import subprocess
import sys
import types

import pytest

from bench.harness import cell as cell_mod
from bench.harness import spec
from bench.tests.tiny import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_last_line_has_the_keys_and_checks_last(capsys):
    line = cell_mod.run_cell(tiny_cell(), 2 ** 31 + 7, 0.3, False,
                             device="cpu", require_cards=False)
    assert cell_mod.emit(line) == 0
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last) == KEYS
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] >= 1
    assert set(last["metrics"]) == {"setup_s", "sweep_ms"}  # no card: no peak
    assert all(m["unit"] for m in last["metrics"].values())
    assert set(last["checks"]) == {"factor_gap", "fit_gap"}
    for v in last["checks"].values():
        assert v["value"] <= v["limit"]
    tail = err.strip().splitlines()[-3:]
    assert tail[0] == "correct: True"
    assert tail[1].startswith("check factor_gap") and "limit" in tail[1]
    assert tail[2].startswith("check fit_gap") and "limit" in tail[2]


def test_a_forbidden_module_refuses_the_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    line = {"correct": True, "checks": {}}
    assert cell_mod.emit(line) == 3
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "chicago.restarts",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120)


def test_without_a_card_no_result(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run_py(spec.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "uber.restarts",
         "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["correct"] is True
    assert last["device"]["platform"] == "gpu"
    assert 0 < last["device"]["busy_s"] <= last["device"]["window_s"]
