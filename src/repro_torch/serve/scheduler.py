"""Micro-batching request scheduler (port of ``repro.serve.scheduler``):
per-bucket queues, submit/future semantics, score-based flushes.

The service sits between callers (one ``SparseTensor`` per request) and
the lockstep ``BatchedEngine`` (B bucket-mates per dispatch):

  * ``submit()`` quantizes the request into its (shape, nnz cap, method)
    bucket (``serve.buckets``), enqueues it, and returns a
    ``DecompositionFuture`` at once.
  * a bucket flushes when its aging + occupancy score reaches 1.0:
    ``score = oldest_wait / max_wait_s + queued / max_batch``.  A full
    bucket flushes at once (the throughput trigger), an expired one
    likewise (the latency trigger), and a partly full bucket that has
    waited most of its budget flushes early.  Every ``submit``/``poll``
    re-scores all buckets and flushes the ready ones, highest score first;
    the aging term grows without bound, so no bucket starves.
    ``flush()`` / ``Future.result()`` force a flush outright.
  * a flush pads every queued tensor to the bucket cap, runs one batched
    decomposition, resolves the futures and records the batch in
    ``ServiceMetrics``.

The scheduler is event-driven, not thread-driven: flushes happen inside
``submit``/``poll``/``result`` calls, so the triggers are deterministic
and testable with an injected ``clock``.  Queue state is guarded by an
RLock; batches are popped under it and run after releasing it.

Double-buffered dispatch (``double_buffer=True``): a flush splits at the
engine's prepare/execute seam.  The host half (``engine.prepare_batch``:
padding, packing, init states, and on the card the uploads on the
engine's copy stream) runs on the flushing caller's thread while the
device half of the previous flush runs on a one-worker dispatch executor,
on the engine's compute stream.  ``ServiceMetrics.record_dispatch``
accumulates the measured overlap; ``join()`` (or ``Future.result()``)
waits out in-flight dispatches.  Results are bitwise the synchronous
service's: the same kernels run on the same inputs in the same order.

Over κ ranks (``DecompositionService(mesh=)`` with ``mesh.size > 1``).
The reference is single-controller: one process cuts the batches and one
``shard_map`` runs them on every device.  The port's mesh is one process
per rank, and flush triggers read each process's clock, so κ schedulers
would cut different batches.  Rank 0 is the controller: it alone takes
submits and runs the triggers.  Before it executes a flush, it
broadcasts the flush (the requests as host arrays and every argument of
``prepare_batch``) to the other ranks, the followers; each prepares the
same batch, the ranks all-gather whether their preparation failed, and
then every rank runs ``BatchedEngine(mesh=)``'s pod path on it, in the
controller's flush order.  Futures resolve on the controller; a
follower's preparation error resolves them with a ``RuntimeError`` that
names the rank.  A follower serves flushes in ``drain()`` until the
controller's ``drain()`` broadcasts a stop.  Every collective of a flush
runs on one thread per rank: the flushing thread, or under double
buffering the dispatch worker; the controller's ``drain()`` broadcasts
its stop after ``join()``.  An error inside the pod's execution on one
rank is not exchanged: the other ranks' gather waits on it until the
process group's timeout.

Engine errors: any ``BaseException`` from either half resolves every
future of the batch (and of the batches popped with it) with the error,
as the reference does.  One that is not an ``Exception`` (a
``KeyboardInterrupt``) then goes on to the flushing caller, or, under
double buffering, to ``join()``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable

import numpy as np

from ..core import plan as plan_mod
from ..core.coo import SparseTensor
from ..core.cpd import CPDResult
from ..obs import clock as obs_clock
from ..obs import trace as obs_trace
from .batched_engine import BatchedEngine, batched_cache_stats
from .buckets import Bucket, BucketPolicy
from .metrics import BatchEvent, ServiceMetrics

# Modes with more rows than this keep the uniform planning prior instead
# of paying per-flush bincount+sort profiling on the caller's thread.
_DENSITY_MAX_ROWS = 65536


class DecompositionFuture:
    """Handle for a submitted request.  ``result()`` force-flushes the
    owning bucket if the request is still queued, so a caller that wants
    its answer *now* never deadlocks waiting for bucket-mates."""

    def __init__(self, scheduler: "BatchScheduler", bucket: Bucket):
        self._scheduler = scheduler
        self._bucket = bucket
        self._done = threading.Event()
        self._result: CPDResult | None = None
        self._exception: BaseException | None = None

    def done(self) -> bool:
        return self._done.is_set()

    def _resolve(self, result: CPDResult | None,
                 exc: BaseException | None = None):
        self._result = result
        self._exception = exc
        self._done.set()

    def result(self, timeout: float | None = None) -> CPDResult:
        """Without ``timeout``: force-flush the owning bucket if the
        request is still queued, run to completion, return.  With
        ``timeout``: wait that long for completion by another caller's
        flush (the bounded wait cannot itself start a flush, whose
        preparation and execution time it could not honor) and raise
        ``TimeoutError`` on expiry."""
        if timeout is not None:
            if not self._done.wait(timeout):
                raise TimeoutError("decomposition not completed")
        elif not self._done.is_set():
            self._scheduler.flush(self._bucket)
            self._done.wait()      # another thread may own the batch
        if self._exception is not None:
            raise self._exception
        assert self._result is not None
        return self._result


@dataclasses.dataclass
class _Pending:
    tensor: SparseTensor
    future: DecompositionFuture
    n_iters: int
    tol: float
    seed: int
    t_submit: float
    init_state: tuple | None = None
    weights: np.ndarray | None = None


class BatchScheduler:
    """Shape-bucketed micro-batching front of the decomposition service."""

    def __init__(self, engine: BatchedEngine, *,
                 policy: BucketPolicy | None = None,
                 max_batch: int = 8,
                 max_wait_s: float = 0.005,
                 batch_quantum: int = 1,
                 metrics: ServiceMetrics | None = None,
                 double_buffer: bool = False,
                 clock: Callable[[], float] = obs_clock.now):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if batch_quantum < 1 or batch_quantum > max_batch:
            raise ValueError(
                f"batch_quantum must be in [1, max_batch], "
                f"got {batch_quantum}")
        self.engine = engine
        self.policy = policy or BucketPolicy()
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.batch_quantum = int(batch_quantum)
        self.metrics = metrics or ServiceMetrics()
        self.clock = clock
        self._queues: dict[Bucket, list[_Pending]] = {}
        self._lock = threading.RLock()
        # Double-buffered dispatch: ONE worker so device executions stay
        # serialized (and in submission order) while the caller thread
        # assembles the next flush.  The worker needs no device or stream
        # set up here: ``engine.execute_prepared`` enters the engine's
        # device and compute stream itself (both are per thread in CUDA).
        # One worker also keeps the kernel wrappers' module-level launch
        # counts (``kernels.mttkrp_slab.LAUNCHES``) exact without a lock.
        # The exec-interval deque feeds the overlap gauge: an assembly
        # interval that intersects another flush's device interval is
        # time the host hid.
        self.double_buffer = bool(double_buffer)
        self._dispatch_pool = (ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-dispatch")
            if double_buffer else None)
        self._inflight: set = set()
        # The first error a finished dispatch carried (only one that is
        # not an ``Exception`` reaches the dispatch future): ``join()``
        # raises it once ``_inflight`` has drained.
        self._dispatch_error: BaseException | None = None
        self._exec_lock = threading.Lock()
        self._exec_intervals: collections.deque = collections.deque(
            maxlen=16)

    # -- request side -------------------------------------------------------

    def submit(self, tensor: SparseTensor, *, n_iters: int = 25,
               tol: float = 1e-5, seed: int = 0, method: str = "cp",
               init_state: tuple | None = None,
               weights: np.ndarray | None = None) -> DecompositionFuture:
        """Enqueue one request.  ``method`` routes to the decomposition
        method's (shape, nnz-bucket, method) class — a mixed-method
        stream batches per method but shares plans and kernels.
        ``init_state`` warm-starts this request (streaming sessions);
        ``weights`` carries per-entry observation confidences for
        weighted-fit methods ('masked') — bucket-mates keep their own
        weight vectors, and the flush pads each with weight-0 entries so
        batching stays exact.

        Weights are validated HERE, eagerly: a flush-time failure would
        belong to the whole batch and fail innocent bucket-mates'
        futures, so a malformed vector (wrong length, NaN, negative, or
        weights on a non-weighted method) must raise at the offending
        caller's submit instead."""
        if weights is not None:
            from ..core.als_device import validate_entry_weights
            from ..methods import get_method

            if not get_method(method).weighted_fit:
                raise ValueError(
                    f"per-entry weights require a weighted-fit method "
                    f"(e.g. 'masked'), got method={method!r}")
            weights = validate_entry_weights(tensor.nnz, weights)
        bucket = self.policy.bucket_for(tensor, method)
        now = self.clock()
        with self._lock:
            fut = DecompositionFuture(self, bucket)
            self._queues.setdefault(bucket, []).append(
                _Pending(tensor, fut, int(n_iters), float(tol), int(seed),
                         now, init_state, weights))
            self.metrics.record_submit(now)
            work = self._pop_ready()
            self._record_queue_locked()
        self._run_batches(work)
        return fut

    def poll(self) -> int:
        """Flush every bucket whose aging+occupancy score has crossed the
        threshold, neediest first.  Returns the number of batches
        flushed.  Call this from the serving loop between request
        arrivals."""
        with self._lock:
            work = self._pop_ready()
            self._record_queue_locked()
        self._run_batches(work)
        return len(work)

    def flush(self, bucket: Bucket | None = None) -> int:
        """Force-flush one bucket (or all).  Returns batches flushed."""
        with self._lock:
            buckets = ([bucket] if bucket is not None
                       else list(self._queues.keys()))
            work = []
            for b in buckets:
                while self._queues.get(b):
                    work.append(self._pop(b, "forced"))
            self._record_queue_locked()
        self._run_batches(work)
        return len(work)

    def pending(self, bucket: Bucket | None = None) -> int:
        with self._lock:
            if bucket is not None:
                return len(self._queues.get(bucket, []))
            return sum(len(q) for q in self._queues.values())

    def join(self) -> None:
        """Wait for every in-flight double-buffered dispatch to complete
        (no-op without ``double_buffer``).  Futures resolve as dispatches
        finish; call this before reading end-of-stream metrics.  An
        error that is not an ``Exception`` (Ctrl-C) raised on the
        dispatch worker is raised here, once, whether its dispatch
        finished before this call or during it."""
        while True:
            with self._lock:
                pending = list(self._inflight)
                if not pending:
                    exc, self._dispatch_error = self._dispatch_error, None
                    break
            wait(pending)
        if exc is not None:
            raise exc

    # -- flush machinery ----------------------------------------------------
    # Pop under the lock, execute outside it: a popped batch belongs to
    # exactly one caller, so the engine (seconds of host preparation
    # on a large bucket) never runs inside the critical section.

    def _record_queue_locked(self) -> None:
        """Refresh the metrics queue-saturation gauges (pending depth +
        oldest queued age).  Caller holds ``self._lock``; the metrics
        object takes its own lock, which is safe — metrics never calls
        back into the scheduler."""
        depth = sum(len(q) for q in self._queues.values())
        oldest = min((q[0].t_submit for q in self._queues.values() if q),
                     default=None)
        age = 0.0 if oldest is None else max(self.clock() - oldest, 0.0)
        self.metrics.record_queue(depth, age)

    def _pop(self, bucket: Bucket, trigger: str):
        q = self._queues.get(bucket, [])
        batch, self._queues[bucket] = q[: self.max_batch], q[self.max_batch:]
        return bucket, batch, trigger

    def _score(self, q: list, now: float) -> float:
        """Aging + occupancy flush score; >= 1.0 means ready.  The aging
        term grows without bound, so every nonempty bucket eventually
        flushes regardless of how busy its neighbors are (starvation
        freedom); the occupancy term lets a filling bucket claim the
        device before its latency budget expires."""
        age = (now - q[0].t_submit) / self.max_wait_s if self.max_wait_s \
            else float("inf")
        return age + len(q) / self.max_batch

    def _pop_ready(self) -> list:
        """Pop every ready bucket (score >= 1), highest score first —
        the cross-bucket replacement for independent per-bucket FIFO
        expiry: when the device frees up, the neediest class wins."""
        now = self.clock()
        scored = []
        for b in list(self._queues.keys()):
            q = self._queues.get(b)
            if not q:
                continue
            s = self._score(q, now)
            if s >= 1.0:
                scored.append((s, b, len(q), now - q[0].t_submit))
        scored.sort(key=lambda e: -e[0])
        work = []
        for _, b, n, age in scored:
            trigger = ("max_batch" if n >= self.max_batch
                       else "max_wait" if age >= self.max_wait_s
                       else "aging")
            work.append(self._pop(b, trigger))
        return work

    def _run_batches(self, work: list) -> None:
        for i, (bucket, batch, trigger) in enumerate(work):
            if not batch:
                continue
            try:
                self._run_one(bucket, batch, trigger)
            except BaseException as exc:
                # _run_one resolved its own batch before re-raising; the
                # batches popped after it get the same error, so no
                # popped future is left pending.
                for _, rest, _ in work[i + 1:]:
                    for p in rest:
                        p.future._resolve(None, exc)
                raise

    def _run_one(self, bucket: Bucket, batch: list, trigger: str) -> None:
        # Cache counters are global; under concurrent flushes another
        # thread's cache miss can land inside this window, so per-batch
        # attribution is best-effort (totals stay exact).
        stats0 = batched_cache_stats()
        # Density feedback: the PREVIOUS flushes' observed row-density
        # EWMA prices this batch's bucket plan; this batch's own profile
        # is folded in afterwards for the next one (so the first flush of
        # a bucket runs under the uniform prior — by construction there
        # is nothing observed yet).
        density = self.metrics.row_density(bucket.key)
        # Batch-size quantization: B is part of the window-function cache
        # key.  Rounding the dispatched B up to the next multiple of
        # ``batch_quantum`` (capped at max_batch) by repeating the last
        # request stabilizes it; lanes are independent, so the duplicate
        # slots change no kept result and are discarded below.
        q = self.batch_quantum
        target = min(self.max_batch, -(-len(batch) // q) * q)
        exec_batch = batch + [batch[-1]] * (target - len(batch))
        t0 = obs_clock.now()
        # The flush span carries the window-function cache hit/miss deltas
        # as attrs, so a trace alone reconstructs the stream's hit rate.
        with obs_trace.span("serve.flush", cat="serve",
                            bucket=str(bucket.key), batch=len(batch),
                            dispatched=len(exec_batch),
                            trigger=trigger,
                            double_buffer=self.double_buffer) as sp:
            # HOST half: padding, layout stacking, init assembly.  Under
            # double buffering this runs while the previous flush's
            # device half is still executing on the dispatch worker —
            # that intersection is the overlap gauge.
            try:
                prep = self.engine.prepare_batch(
                    [p.tensor for p in exec_batch],
                    n_iters=[p.n_iters for p in exec_batch],
                    tol=[p.tol for p in exec_batch],
                    seeds=[p.seed for p in exec_batch],
                    nnz_cap=bucket.nnz_cap,
                    method=bucket.method,
                    init_states=[p.init_state for p in exec_batch],
                    density=density,
                    weights=[p.weights for p in exec_batch],
                )
            except BaseException as exc:
                # Executor semantics: the failure belongs to the batch's
                # own futures (raised from their result()), never to
                # whichever caller's submit/poll happened to trigger the
                # flush — a submitter must still receive its future for
                # an unrelated bucket's engine error.  Any BaseException
                # resolves them, as in the reference; one that is not an
                # Exception (Ctrl-C) then goes on to the caller.
                sp.set(error=type(exc).__name__)
                for p in batch:
                    p.future._resolve(None, exc)
                if not isinstance(exc, Exception):
                    raise
                return
            t_prep = obs_clock.now()
            assembly_s = t_prep - t0
            overlap_s = self._overlap_with_exec(t0, t_prep)
            if self._dispatch_pool is None:
                # Synchronous path (the default): device half inline,
                # span covers the whole flush.
                self._execute_one(bucket, batch, exec_batch, trigger,
                                  prep, stats0, t0, assembly_s,
                                  overlap_s, sp)
            else:
                fut = self._dispatch_pool.submit(
                    self._execute_one, bucket, batch, exec_batch, trigger,
                    prep, stats0, t0, assembly_s, overlap_s, None)
                with self._lock:
                    self._inflight.add(fut)
                fut.add_done_callback(self._inflight_discard)
                sp.set(assembly_s=assembly_s, overlap_s=overlap_s,
                       dispatched_async=True)

    def _inflight_discard(self, fut) -> None:
        # Record the error before the future leaves ``_inflight``: a
        # dispatch that finishes before ``join()`` looks is no longer
        # there for it to read.
        exc = fut.exception()
        with self._lock:
            if exc is not None and self._dispatch_error is None:
                self._dispatch_error = exc
            self._inflight.discard(fut)

    def _overlap_with_exec(self, a0: float, a1: float) -> float:
        """Seconds of the assembly interval [a0, a1] spent while some
        other flush's device dispatch was executing — the double-buffer
        overlap witness.  A still-running dispatch counts up to a1."""
        with self._exec_lock:
            intervals = [(e[0], e[1]) for e in self._exec_intervals]
        total = 0.0
        for e0, e1 in intervals:
            hi = a1 if e1 is None else min(a1, e1)
            total += max(0.0, hi - max(a0, e0))
        return total

    def _execute_one(self, bucket: Bucket, batch: list, exec_batch: list,
                     trigger: str, prep, stats0: dict, t0: float,
                     assembly_s: float, overlap_s: float, sp) -> None:
        """DEVICE half of one flush (+ future resolution and metrics).
        Runs inline on the flushing thread (sync path, ``sp`` = the open
        flush span) or on the one-worker dispatch executor (double
        buffering, ``sp`` = None and a ``serve.dispatch`` span is opened
        here)."""
        interval = [obs_clock.now(), None]
        with self._exec_lock:
            self._exec_intervals.append(interval)
        try:
            try:
                if sp is None:
                    with obs_trace.span("serve.dispatch", cat="serve",
                                        bucket=str(bucket.key),
                                        dispatched=len(exec_batch),
                                        devices=self.engine.num_devices,
                                        trigger=trigger):
                        results = self.engine.execute_prepared(prep)
                else:
                    results = self.engine.execute_prepared(prep)
            except BaseException as exc:
                if sp is not None:
                    sp.set(error=type(exc).__name__)
                for p in batch:
                    p.future._resolve(None, exc)
                if not isinstance(exc, Exception):
                    raise
                return
        finally:
            interval[1] = obs_clock.now()
        execute_s = interval[1] - interval[0]
        wall = obs_clock.now() - t0
        stats1 = batched_cache_stats()
        if sp is not None:
            sp.set(wall_s=wall,
                   cache_hits=stats1["hits"] - stats0["hits"],
                   cache_misses=stats1["misses"] - stats0["misses"])
        now = self.clock()
        for p, res in zip(batch, results):
            p.future._resolve(res)
        # Per-mode observed row-density of this batch (unpadded tensors),
        # averaged across the batch, folded into the bucket's EWMA.  Modes
        # too large to profile cheaply (bincount+sort is O(I_d log I_d)
        # host work on the flushing caller's thread) are skipped — a None
        # profile keeps the uniform prior for that mode only.
        shape = bucket.shape
        profiles = tuple(
            (None if shape[d] > _DENSITY_MAX_ROWS else
             tuple(float(np.mean(col)) for col in zip(*[
                 plan_mod.density_profile(p.tensor.indices, shape, d)
                 for p in batch])))
            for d in range(len(shape))
        )
        mesh = self.engine.mesh
        device_ids = (mesh.ranks if mesh is not None
                      else [int(self.engine.device.index or 0)])
        with self._lock:
            self.metrics.record_density(bucket.key, profiles)
            self.metrics.record_batch(
                BatchEvent(
                    bucket_key=bucket.key,
                    batch_size=len(batch),
                    max_batch=self.max_batch,
                    real_nnz=sum(p.tensor.nnz for p in batch),
                    padded_nnz=bucket.nnz_cap * len(exec_batch),
                    wall_s=wall,
                    trigger=trigger,
                    cache_hits=stats1["hits"] - stats0["hits"],
                    cache_misses=stats1["misses"] - stats0["misses"],
                ),
                latencies_s=[now - p.t_submit for p in batch],
                now=now,
            )
            self.metrics.record_dispatch(
                devices=device_ids, assembly_s=assembly_s,
                execute_s=execute_s, overlap_s=overlap_s)


class _Controller:
    """Rank 0's front of the engine on a mesh of several ranks, in the
    scheduler's place of the engine: ``prepare_batch`` prepares the
    controller's lanes and keeps the flush's arguments;
    ``execute_prepared`` broadcasts them to the followers, raises if any
    rank failed to prepare, and runs the pod path (see the module
    docstring)."""

    def __init__(self, engine: BatchedEngine):
        self.engine = engine
        self.mesh = engine.mesh
        self.device = engine.device
        self.num_devices = engine.num_devices

    def prepare_batch(self, tensors, **kw):
        return (list(tensors), kw), self.engine.prepare_batch(tensors, **kw)

    def execute_prepared(self, prepared) -> list[CPDResult]:
        flush, prep = prepared
        self.mesh.broadcast_object(flush)
        failed = [f"rank {r} failed to prepare the flush: {e}"
                  for r, e in enumerate(self.mesh.all_gather_object(None))
                  if e is not None]
        if failed:
            raise RuntimeError("; ".join(failed))
        return self.engine.execute_prepared(prep)


def _serve_flushes(engine: BatchedEngine) -> int:
    """A follower rank: prepare and run every flush the controller
    broadcasts, until its stop (``None``); returns the flushes run."""
    mesh, served = engine.mesh, 0
    while (flush := mesh.broadcast_object(None)) is not None:
        tensors, kw = flush
        prep, err = None, None
        try:
            prep = engine.prepare_batch(tensors, **kw)
        except Exception as exc:
            err = f"{type(exc).__name__}: {exc}"
        if all(e is None for e in mesh.all_gather_object(err)):
            engine.execute_prepared(prep)
            served += 1
    return served


class DecompositionService:
    """Convenience facade: engine + scheduler + metrics in one object.
    ``device`` defaults to the card and raises without it.  ``mesh`` (a
    batch mesh) runs every flush through the engine's pod path.  On a
    mesh of several ranks every rank builds the service; rank 0, the
    controller, takes the submits, and the other ranks call ``drain()``,
    which serves the controller's flushes until the controller's own
    ``drain()`` (see the module docstring).  ``submit`` and ``poll``
    raise on a follower.

    >>> svc = DecompositionService(rank=16, max_batch=8)
    >>> futs = [svc.submit(t) for t in tensors]
    >>> svc.drain()
    >>> results = [f.result() for f in futs]
    """

    def __init__(self, rank: int, *, kappa: int = 1,
                 backend: str = "slab", check_every: int = 4,
                 policy: BucketPolicy | None = None, max_batch: int = 8,
                 max_wait_s: float = 0.005, batch_quantum: int = 1,
                 double_buffer: bool = False, slo=None,
                 clock: Callable[[], float] = obs_clock.now,
                 device="cuda", mesh=None):
        self.engine = BatchedEngine(rank, kappa=kappa, backend=backend,
                                    check_every=check_every,
                                    batch_quantum=batch_quantum,
                                    device=device, mesh=mesh)
        # slo: an obs.health.SLOPolicy; snapshot() then carries a live
        # "health" section and breach onsets emit health.breach events.
        self.metrics = ServiceMetrics(slo=slo)
        several = self.engine.num_devices > 1
        self.controller = not several or mesh.rank == 0
        self.scheduler = BatchScheduler(
            _Controller(self.engine) if several else self.engine,
            policy=policy, max_batch=max_batch, max_wait_s=max_wait_s,
            batch_quantum=batch_quantum, double_buffer=double_buffer,
            metrics=self.metrics, clock=clock)

    def _refuse_on_follower(self, what: str) -> None:
        if not self.controller:
            raise RuntimeError(
                f"{what} on rank {self.engine.mesh.rank}: only the controller, "
                f"rank 0, takes requests; a follower serves its flushes in drain()")

    def submit(self, tensor: SparseTensor, **kw) -> DecompositionFuture:
        self._refuse_on_follower("submit")
        return self.scheduler.submit(tensor, **kw)

    def poll(self) -> int:
        self._refuse_on_follower("poll")
        return self.scheduler.poll()

    def drain(self) -> int:
        """Flush everything still queued, then wait for any in-flight
        double-buffered dispatches to land (futures resolved).  Over
        several ranks the controller then broadcasts a stop, and a
        follower serves flushes until that stop.  Returns the batches
        flushed (on a follower: served)."""
        if not self.controller:
            return _serve_flushes(self.engine)
        n = self.scheduler.flush()
        self.scheduler.join()
        if self.engine.num_devices > 1:
            self.engine.mesh.broadcast_object(None)      # the followers' stop
        return n

    def snapshot(self) -> dict:
        return self.metrics.snapshot()
