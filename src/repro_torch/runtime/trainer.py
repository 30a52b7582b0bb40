"""Training orchestrator, decomposition front door and straggler
monitoring (port of ``repro.runtime.trainer``: ``Trainer``,
``StragglerMonitor`` and ``ALSRunner``).

``Trainer`` trains an LM of ``repro_torch.models`` on a token pipeline.
Fault model, as the reference's:
  * preemption/crash -- every state that matters (params, optimizer,
    data-pipeline cursor, step) is checkpointed atomically; ``run()``
    begins by restoring the latest committed checkpoint, so a restarted
    job continues bit-identically (deterministic pipeline, deterministic
    step: ``launch.steps``).
  * stragglers -- per-step wall time feeds a ``StragglerMonitor``.
  * elastic scaling -- the checkpoint is host numpy, written once (by
    rank 0: every rank holds the same parameters), and restores onto a
    mesh of any size; each rank then takes its own slice of the pipeline.
The mesh is 1-D over ``torch.distributed`` ranks (``launch.make_host_mesh``,
axis ``data``): each rank holds the whole parameter and optimizer state,
takes its slice of the global batch, and the step averages gradients
over the ranks.  The reference shards the parameters over ``data`` as
well (ZeRO-3); ``p_shard`` holds those specs, which the port does not
execute.  One host read a step, of the loss and the gradient norm
together; on the card the step itself runs under
``set_sync_debug_mode("error")`` (unless the mesh stages its collectives
through the host), so any other read in it raises.

``ALSRunner`` serves decompositions through the batched service
(``mode="batched"``, the default) or one request at a time through the
fused engine (``mode="sequential"``), and opens streaming sessions routed
through itself.  Each request's wall time feeds a ``StragglerMonitor``
(EWMA mean and variance); ``history`` records each request's
window-function cache hit/miss delta (``sweep_cache_stats`` /
``batched_cache_stats``), so a straggler caused by a cache miss (a new
bucket or window class: "retrace") is told apart from one on a warm
class ("contention").  Entry points default to ``device="cuda"`` and
``backend="slab"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np

import torch

from .. import optim
from ..checkpoint.manager import CheckpointManager
from ..core.coo import SparseTensor
from ..core.cpd import CPDResult
from ..device import no_host_sync, resolve_device
from ..launch import shardings as shd
from ..launch import steps as steps_mod
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


class Trainer:
    """Trains ``model`` on ``pipeline`` over ``mesh`` (a ``launch.Mesh``
    whose ranks each take their slice of the batch: the pipeline's
    ``process_index`` and ``process_count`` must be the mesh's rank and
    size).  ``failure_hook(step)`` runs after every step and may raise."""

    def __init__(self, model, *, mesh, pipeline, opt_cfg=None,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 keep: int = 3, microbatch: int = 1,
                 failure_hook: Callable[[int], None] | None = None):
        self.model = model
        self.mesh = mesh
        self.device = mesh.device
        self.pipeline = pipeline
        self.opt_cfg = opt_cfg or optim.AdamWConfig()
        self.ckpt = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.monitor = StragglerMonitor()
        self.failure_hook = failure_hook
        self.step = 0
        self.history: list[dict] = []
        self.host_reads = 0

        self.p_shard = shd.param_shardings(model, mesh)
        self.o_shard = shd.opt_state_shardings(self.p_shard, mesh)
        self.b_shard = shd.batch_shardings(
            {"tokens": torch.empty((pipeline.batch, pipeline.seq), device="meta")}, mesh)
        if self.b_shard["tokens"][0] is None:
            raise ValueError(f"the batch rule shards no global batch of "
                             f"{pipeline.batch} over the mesh axes "
                             f"{dict(zip(mesh.axis_names, mesh.axis_sizes))}")
        if (pipeline.process_index, pipeline.process_count) != (mesh.rank, mesh.size):
            raise ValueError(
                f"the pipeline slices the batch for rank {pipeline.process_index} "
                f"of {pipeline.process_count}, the mesh is rank {mesh.rank} of "
                f"{mesh.size}")
        self._step_fn = steps_mod.make_train_step(model, self.opt_cfg,
                                                  microbatch=microbatch, mesh=mesh)
        # A gloo collective stages CUDA tensors through the host: a read.
        self.sync_guard = mesh.group is None or mesh.backend != "gloo"
        self.params = None
        self.opt_state = None

    # -- state --------------------------------------------------------------

    def initialize(self, seed: int = 0):
        """Fresh init or restore-from-latest (fault-tolerant entry)."""
        if self.ckpt and self.ckpt.latest_step() is not None:
            abstract = self.model.abstract_params()
            template = {"params": abstract, "opt": optim.init_state(abstract)}
            state, extra = self.ckpt.restore(template=template, device=self.device)
            self.params, self.opt_state = state["params"], state["opt"]
            self.step = int(extra["step"])
            self.pipeline.restore(extra["pipeline"])
            return "restored"
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.model.init(gen, self.device)
        self.opt_state = optim.init_state(self.params)
        return "initialized"

    def save(self, block: bool = False):
        """Checkpoint the state at ``self.step`` (rank 0 writes; the other
        ranks hold the same state)."""
        if not self.ckpt or self.mesh.rank != 0:
            return
        self.ckpt.save(
            self.step,
            {"params": self.params, "opt": self.opt_state},
            extra={"step": self.step, "pipeline": self.pipeline.snapshot()},
            block=block,
        )

    # -- loop ----------------------------------------------------------------

    def _mark(self):
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def train_one(self) -> dict:
        """One step on the pipeline's next batch; returns its record.  The
        old parameter and optimizer trees are dropped once the new ones
        exist (the reference donates them)."""
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in next(self.pipeline).items()}
        guard = no_host_sync(self.device) if self.sync_guard else contextlib.nullcontext()
        t0 = obs_clock.now()
        start = self._mark()
        with guard:
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            end = self._mark()
        loss, gnorm = torch.stack([metrics["loss"].float(),
                                   metrics["grad_norm"].float()]).tolist()
        self.host_reads += 1
        dt = obs_clock.now() - t0
        self.step += 1
        rec = {"step": self.step, "loss": loss, "grad_norm": gnorm, "time_s": dt,
               "straggler": self.monitor.observe(self.step, dt)}
        if start is not None:
            rec["device_ms"] = start.elapsed_time(end)
        self.history.append(rec)
        return rec

    def run(self, num_steps: int, *, log_every: int = 10,
            log: Callable[[str], None] = print) -> list[dict]:
        """Train until step ``num_steps``; returns this call's records
        (step, loss, grad_norm, time_s, straggler; device_ms on the card)."""
        if self.params is None:
            mode = self.initialize()
            log(f"[trainer] {mode} at step {self.step}")
        history = []
        while self.step < num_steps:
            rec = self.train_one()
            history.append(rec)
            if self.step % log_every == 0:
                log(f"[trainer] step {rec['step']:5d} "
                    f"loss {rec['loss']:.4f} ({rec['time_s']*1e3:.0f} ms)"
                    + (" STRAGGLER" if rec["straggler"] else ""))
            if self.ckpt and self.step % self.ckpt_every == 0:
                self.save()
            if self.failure_hook:
                self.failure_hook(self.step)   # may raise (tests)
        if self.ckpt:
            self.save(block=True)
        return history
