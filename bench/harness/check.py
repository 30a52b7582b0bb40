"""The comparison that decides ``correct``.

A sample of the window's calls, drawn from the seed, is held to the
configuration's plain reference (``bench/reference/<reference>.py``),
which recomputes each call from the tensor and the initial factors the
benchmark handed to the program.  Two numbers are compared, each the
worst over the sampled calls:

    factor_gap  the largest relative gap, ||P - Q||_F / ||Q||_F, of a
                column-normalized factor or of the weights
    fit_gap     the largest gap of a sweep's fit

A call that raised, returned a non-finite number or fewer sweeps than
the reference reads ``inf``.
"""
from __future__ import annotations

import importlib.util
import math

import numpy as np
import torch

from .spec import BENCH_DIR

NUMBERS = ("factor_gap", "fit_gap")


def load_reference(name: str, bench_dir=BENCH_DIR):
    path = bench_dir / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_reference_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sample(calls, k: int, seed: int) -> list:
    """``k`` of ``calls`` drawn from the seed, in call order."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 3])
    k = min(k, len(calls))
    pick = sorted(rng.choice(len(calls), size=k, replace=False).tolist())
    return [calls[i] for i in pick]


def _rel(p, q: torch.Tensor) -> float:
    p = torch.as_tensor(np.asarray(p), dtype=torch.float64, device=q.device)
    if p.shape != q.shape:
        return math.inf
    return float(torch.linalg.vector_norm(p - q)
                 / torch.clamp(torch.linalg.vector_norm(q), min=1e-300))


def gaps(answer, reference) -> dict:
    """``{"factor_gap", "fit_gap"}`` of an answer ``(factors, weights,
    fits)`` against the reference's."""
    factors, weights, fits = answer
    rf, rw, rfits = reference
    rf = [F.double() for F in rf]
    fits = np.asarray(fits, dtype=np.float64)
    if fits.shape[0] != rfits.shape[0] or not np.all(np.isfinite(fits)):
        fit_gap = math.inf
    else:
        fit_gap = float((torch.as_tensor(fits, device=rfits.device)
                         - rfits.double()).abs().max())
    factor_gap = max([_rel(p, q) for p, q in zip(factors, rf)]
                     + [_rel(weights, rw.double())])
    if not math.isfinite(factor_gap):
        factor_gap = math.inf
    return {"factor_gap": factor_gap, "fit_gap": fit_gap}


def reference_run(ref, indices, values, shape, init, n_sweeps, device,
                  precision="float64"):
    return ref.cp_als(torch.as_tensor(indices, device=device),
                      torch.as_tensor(values, device=device), shape, init,
                      n_sweeps, precision=precision)


def compare(calls, cell, indices, values, seed: int, device) -> dict:
    """The worst of each number over the sampled calls."""
    config, traffic = cell.config, cell.traffic
    ref = load_reference(config["reference"], cell.bench_dir)
    worst = {k: 0.0 for k in NUMBERS}
    for c in sample(calls, traffic["checked_calls"], seed):
        if not c.ok:
            return {k: math.inf for k in NUMBERS}
        r = reference_run(ref, indices, values, config["shape"], c.init,
                          traffic["n_iters"], device)
        g = gaps((c.result.factors, c.result.weights, c.result.fits), r)
        worst = {k: max(worst[k], g[k]) for k in NUMBERS}
    return worst


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``; a number with no limit,
    or a limit with no number, is not correct."""
    table = {k: {"value": readings.get(k, math.inf),
                 "limit": limits.get(k, -math.inf)}
             for k in sorted(set(readings) | set(limits))}
    ok = bool(table) and all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
