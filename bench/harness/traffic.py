"""The general loop every traffic file parameterises.

A traffic file (``bench/traffic/<name>.json``) sets the parameters of one
closed loop, in which one analyst process makes the next call as the last
one returns, each from factors drawn from ``(seed, call index)``:

    n_iters        sweeps per call
    check_every    sweeps per window of the fused engine (one host read each)
    tol            the call's stopping tolerance; 0 fixes the work per call
    warmup_calls   calls in set-up, before the window
    traced_calls   calls in the profiled stretch of a traced run
    checked_calls  calls, drawn from the seed, held to the reference

A call is ``cpd_als(tensor, rank, plan=plan, n_iters=, check_every=,
tol=, init_state=<benchmark-made state>)``.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from . import data

WARMUP_CALL = 1 << 30          # the call index the warm-up draws from
KEYS = ("n_iters", "check_every", "tol", "warmup_calls", "traced_calls",
        "checked_calls")


def validate(traffic: dict) -> dict:
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise ValueError(f"traffic file lacks {missing}")
    return traffic


@dataclasses.dataclass
class Call:
    index: int
    init: list                  # the initial factors handed to the program
    init_weights: np.ndarray
    result: object = None       # CPDResult
    error: str | None = None
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        if self.result is None:
            return False
        return (all(np.isfinite(F).all() for F in self.result.factors)
                and bool(np.isfinite(self.result.weights).all())
                and bool(np.isfinite(self.result.fits).all()))


def host_state(factors, weights) -> tuple:
    """The program's host state tuple: factors, their grams, weights."""
    factors = tuple(np.asarray(F, dtype=np.float32) for F in factors)
    return (factors, tuple(F.T @ F for F in factors),
            np.asarray(weights, dtype=np.float32))


class Client:
    """One analyst: draws each call's initial state and makes the call."""

    def __init__(self, cpd_als, tensor, plan, config: dict, traffic: dict,
                 seed: int, device):
        self.cpd_als = cpd_als
        self.tensor = tensor
        self.plan = plan
        self.config = config
        self.traffic = validate(traffic)
        self.seed = seed
        self.device = device

    def call(self, index: int) -> Call:
        rank = self.config["rank"]
        factors = data.init_factors(self.config["shape"], rank, self.seed,
                                    index)
        weights = np.ones(rank, np.float32)
        c = Call(index=index, init=factors, init_weights=weights)
        t0 = time.perf_counter()
        try:
            c.result = self.cpd_als(
                self.tensor, self.config["rank"], plan=self.plan,
                n_iters=self.traffic["n_iters"],
                check_every=self.traffic["check_every"],
                tol=self.traffic["tol"], method=self.config["method"],
                backend=self.config["backend"],
                init_state=host_state(factors, weights), device=self.device)
        except Exception as exc:   # a failed call is counted, not fatal
            c.error = f"{type(exc).__name__}: {exc}"
        c.seconds = time.perf_counter() - t0
        return c

    def warm_up(self) -> None:
        for _ in range(self.traffic["warmup_calls"]):
            c = self.call(WARMUP_CALL)
            if not c.ok:
                raise RuntimeError(f"the warm-up call failed: {c.error}")

    def closed_loop(self, seconds: float, first: int = 0,
                    max_calls: int | None = None):
        """Calls back to back until ``seconds`` have passed (a call started
        before then runs to its end) or ``max_calls`` were made.  Returns
        the calls and the seconds from the first call's start to the last
        one's end."""
        calls = []
        limit = math.inf if max_calls is None else max_calls
        t0 = time.perf_counter()
        while len(calls) < limit and time.perf_counter() - t0 < seconds:
            calls.append(self.call(first + len(calls)))
        return calls, time.perf_counter() - t0
