"""What a cell is made of, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic; each of
those, each metric and each cell's limits live in a file of their own:

    bench/configs/<config>.json     sizes, precision, generator, reference
    bench/traffic/<traffic>.json    parameters of the general loop
    bench/metrics/<metric>.py       ``read(run) -> float | None``
    bench/limits/<workload>.json    the limit of each number compared

so a later change adds a cell, a configuration, a traffic mix or a metric
by adding files and entries, without editing one that is there.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: Path = BENCH_DIR

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


def reports(metric: dict, workload: str, e2e_names: set[str]) -> bool:
    """Whether ``workload`` reports ``metric``: listed under its
    ``workloads``, or, without that key, every cell that reports the
    end-to-end metric it moves (for an end-to-end metric: every cell)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def find_cell(name: str, bench: dict, bench_dir: Path = BENCH_DIR) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    wl = cells[name]
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, name, e2e_names)]
    return Cell(
        workload=wl,
        config=_load_json(bench_dir / "configs" / f"{wl['config']}.json"),
        traffic=_load_json(bench_dir / "traffic" / f"{wl['traffic']}.json"),
        limits=_load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
        bench_dir=bench_dir,
    )


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader {path}")
    module_name = "bench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
