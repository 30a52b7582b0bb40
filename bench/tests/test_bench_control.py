"""The control: the reference computed in TF32, the nearest precision
below the configuration's float32 with TF32 off, put in the program's
place, comes out not correct.  (On the card, at each cell's own size,
``bench/control.py`` reads it; ``PERF.md`` holds those readings.)"""
import dataclasses

import numpy as np
import torch

from bench.harness import cell as cell_mod
from bench.reference import cp_als as ref
from bench.tests.tiny import tiny_cell
from repro_torch.core import cpd


@dataclasses.dataclass
class Answer:
    factors: list
    weights: np.ndarray
    fits: list
    iters: int
    host_syncs: int = 0


def tf32_in_place(tensor, rank, *, n_iters, init_state, **_):
    F, w, fits = ref.cp_als(torch.as_tensor(tensor.indices),
                            torch.as_tensor(tensor.values), tensor.shape,
                            list(init_state[0]), n_iters, precision="tf32")
    return Answer([f.numpy() for f in F], w.numpy().astype(np.float64),
                  fits.tolist(), n_iters)


def test_tf32_control_is_not_correct(monkeypatch):
    monkeypatch.setattr(cpd, "cpd_als", tf32_in_place)
    for seed in (11, 12, 13):
        line = cell_mod.run_cell(tiny_cell("uber.restarts"), seed, 0.2,
                                 False, device="cpu", require_cards=False)
        assert line["failed"] == 0
        assert line["correct"] is False
        assert any(v["value"] > v["limit"]
                   for v in line["checks"].values())
