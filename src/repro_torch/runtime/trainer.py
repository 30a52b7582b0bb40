"""Decomposition front door and straggler monitoring (port of
``repro.runtime.trainer``: ``StragglerMonitor`` and ``ALSRunner``).

``ALSRunner`` serves decompositions through the batched service
(``mode="batched"``, the default) or one request at a time through the
fused engine (``mode="sequential"``), and opens streaming sessions routed
through itself.  Each request's wall time feeds a ``StragglerMonitor``
(EWMA mean and variance); ``history`` records each request's
window-function cache hit/miss delta (``sweep_cache_stats`` /
``batched_cache_stats``), so a straggler caused by a cache miss (a new
bucket or window class: "retrace") is told apart from one on a warm
class ("contention").  Entry points default to ``device="cuda"`` and
``backend="slab"``.  The reference's LM ``Trainer`` is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..checkpoint.manager import CheckpointManager
from ..core.coo import SparseTensor
from ..core.cpd import CPDResult
from ..device import resolve_device
from ..obs import clock as obs_clock


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.2
    sigma: float = 4.0
    warmup: int = 3
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            self.mean = dt if self.n == 1 else (
                self.mean + (dt - self.mean) / self.n)
            self.var = max(self.var, (dt - self.mean) ** 2)
            return False
        flagged = bool(dt > self.mean + self.sigma * max(np.sqrt(self.var), 1e-4))
        if flagged:
            self.events.append((step, dt, self.mean))
        else:
            d = dt - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return flagged


class ALSRunner:
    """Decomposition-as-a-service front door.

    ``mode="batched"`` (default) delegates to the serving subsystem
    (``repro_torch.serve``): requests are quantized into (shape, nnz cap,
    method) classes, micro-batched per bucket, and run as one lockstep
    batch per flush -- ``decompose_async``/``flush`` expose the throughput
    path, while the synchronous ``decompose`` force-flushes its own
    bucket.  ``mode="sequential"`` keeps the one-request-at-a-time fused
    engine.  ``history`` records the per-request window-function cache
    hit/miss delta, and each request's wall time feeds the
    ``StragglerMonitor``.
    """

    def __init__(self, rank: int, *, kappa: int = 1, backend: str = "slab",
                 engine: str = "fused", check_every: int = 4,
                 monitor: StragglerMonitor | None = None,
                 mode: str | None = None, max_batch: int = 8,
                 max_wait_s: float = 0.005, batch_quantum: int = 1,
                 policy=None, device="cuda"):
        if mode is None:
            # The batched service where it supports the configuration;
            # engine="host" runs on the sequential path.
            mode = ("batched" if engine == "fused"
                    and backend in ("slab", "segment", "coo")
                    else "sequential")
        if mode not in ("batched", "sequential"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "batched" and engine != "fused":
            raise ValueError("mode='batched' requires engine='fused'; "
                             "use mode='sequential' for engine='host'")
        self.rank = rank
        self.kappa = kappa
        self.backend = backend
        self.engine = engine
        self.check_every = check_every
        self.mode = mode
        self.monitor = monitor or StragglerMonitor()
        self.device = resolve_device(device)
        self.history: list[dict] = []
        self.service = None
        if mode == "batched":
            from ..serve import DecompositionService

            self.service = DecompositionService(
                rank, kappa=kappa, backend=backend, check_every=check_every,
                policy=policy, max_batch=max_batch, max_wait_s=max_wait_s,
                batch_quantum=batch_quantum, device=self.device)

    def _cache_stats(self) -> dict:
        if self.mode == "batched":
            from ..serve import batched_cache_stats

            return batched_cache_stats()
        from ..core.als_device import sweep_cache_stats

        return sweep_cache_stats()

    def _record(self, tensor: SparseTensor, res: CPDResult, dt: float,
                cache_before: dict, log: Callable[[str], None]) -> None:
        after = self._cache_stats()
        req = len(self.history) + 1
        flagged = self.monitor.observe(req, dt)
        rec = {"request": req, "shape": tuple(tensor.shape),
               "nnz": tensor.nnz, "fit": res.fits[-1] if res.fits else 0.0,
               "iters": res.iters, "host_syncs": res.host_syncs,
               "time_s": dt, "straggler": flagged,
               "sweep_cache_hits": after["hits"] - cache_before["hits"],
               "sweep_cache_misses": after["misses"] - cache_before["misses"]}
        self.history.append(rec)
        if flagged:
            cause = ("retrace" if rec["sweep_cache_misses"] else "contention")
            log(f"[als] request {req} STRAGGLER ({cause}): {dt*1e3:.0f} ms "
                f"(mean {self.monitor.mean*1e3:.0f} ms)")

    def decompose(self, tensor: SparseTensor, *, n_iters: int = 25,
                  tol: float = 1e-5, seed: int = 0, method: str = "cp",
                  init_state: tuple | None = None,
                  weights=None, verbose: bool = False,
                  log: Callable[[str], None] = print) -> CPDResult:
        """Decompose one tensor.  ``method`` selects the decomposition
        method ('cp', 'nncp', 'masked' — see ``repro_torch.methods``); in
        batched mode the request lands in its (shape, nnz-bucket, method)
        class, so mixed-method callers batch per method automatically.
        ``init_state`` warm-starts from existing factors (streaming);
        ``weights`` carries per-entry observation confidences for
        weighted-fit methods ('masked')."""
        from ..core.cpd import cpd_als

        before = self._cache_stats()
        t0 = obs_clock.now()
        if self.mode == "batched":
            fut = self.service.submit(tensor, n_iters=n_iters, tol=tol,
                                      seed=seed, method=method,
                                      init_state=init_state,
                                      weights=weights)
            res = fut.result()    # force-flushes this request's bucket
            if verbose:           # post-hoc trajectory at window boundaries
                for i in range(self.check_every - 1, len(res.fits),
                               self.check_every):
                    log(f"  ALS iter {i + 1:3d}: fit={res.fits[i]:.6f} "
                        f"(batched/{method})")
        else:
            res = cpd_als(
                tensor, self.rank, kappa=self.kappa, n_iters=n_iters, tol=tol,
                seed=seed, backend=self.backend, engine=self.engine,
                check_every=self.check_every, method=method,
                init_state=init_state, weights=weights, verbose=verbose,
                device=self.device,
            )
        dt = obs_clock.now() - t0
        self._record(tensor, res, dt, before, log)
        return res

    def decompose_async(self, tensor: SparseTensor, *, n_iters: int = 25,
                        tol: float = 1e-5, seed: int = 0,
                        method: str = "cp", init_state: tuple | None = None,
                        weights=None):
        """Submit without blocking (batched mode only): returns a
        ``DecompositionFuture``.  The request completes when its bucket
        flushes (max-batch, max-wait via ``poll()``, ``flush()``, or the
        future's own ``result()``).  Async completions are recorded in
        ``service.metrics``, not ``history``."""
        if self.service is None:
            raise RuntimeError("decompose_async requires mode='batched'")
        return self.service.submit(tensor, n_iters=n_iters, tol=tol,
                                   seed=seed, method=method,
                                   init_state=init_state, weights=weights)

    def open_stream(self, *, method: str = "cp", refine_iters: int = 2,
                    policy="auto", decay: float | None = None,
                    weight_floor: float = 0.0,
                    resume_from: str | None = None,
                    session_id: str | None = None):
        """Open a streaming-CP session routed through this runner: every
        cold fit and warm refinement window goes through the same front
        door (and, in batched mode, the same bucketed service — so
        concurrent sessions of one bucket class batch together).

        ``policy`` / ``decay`` / ``weight_floor`` configure the session's
        bucket quantization and confidence-decay eviction (see
        ``StreamingCP``).  ``resume_from`` names a checkpoint directory:
        if it holds a committed session snapshot the stream resumes from
        it (same tensor, factors, seed, decay clock, and bucket cap —
        rerouted through THIS runner); otherwise a fresh session is
        returned, so one call site serves both cold start and restart
        after a crash."""
        from ..methods import StreamingCP

        if resume_from is not None:
            mgr = CheckpointManager(str(resume_from))
            if mgr.latest_step() is not None:
                return StreamingCP.restore(mgr, runner=self)
        return StreamingCP(self.rank, method=method, backend=self.backend,
                           kappa=self.kappa, check_every=self.check_every,
                           refine_iters=refine_iters, runner=self,
                           policy=policy, decay=decay,
                           weight_floor=weight_floor, session_id=session_id)

    def poll(self) -> int:
        return self.service.poll() if self.service else 0

    def flush(self) -> int:
        return self.service.drain() if self.service else 0
