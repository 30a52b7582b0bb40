"""Service telemetry (port of ``repro.serve.metrics``): throughput,
latency percentiles, padding overhead, batch occupancy, window-function
cache hit rates, dispatch overlap, streaming-session gauges.

The scheduler records one event per flushed batch and one latency per
completed request; ``snapshot()`` reduces them to a dashboard dict with
the reference's keys.  Memory is bounded: counts, padding, occupancy,
cache and trigger totals are running aggregates, while latency
percentiles cover a sliding window of the most recent ``window``
requests (``batches`` keeps only the most recent events).

Planning feedback: ``record_density`` keeps an EWMA of each bucket's
observed per-mode row-density profile (``core.plan.density_profile``)
and ``row_density`` hands the scheduler a copy quantized to a 1/16 grid
for ``core.plan.plan_bucket(density=...)``, which bounds how many
distinct plans one bucket can cycle through.

Streaming sessions routed through a runner report one
``record_stream_increment`` per update (``start()`` registers the
residency gauges without counting); ``snapshot()["streams"]`` exposes
them.

SLO health: construct with ``slo=obs.health.SLOPolicy(...)`` and every
``snapshot()`` carries a ``health`` section, with breach onsets emitted
as edge-triggered ``health.breach`` trace events.

Thread safety: ServiceMetrics carries its own lock over the batch,
request, queue and density state; stream recording keeps a separate
``_streams_lock``.  The two locks are never held together.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np

from ..obs import health as obs_health

_DENSITY_EWMA = 0.3
_DENSITY_QUANTUM = 1.0 / 16.0


@dataclasses.dataclass
class BatchEvent:
    bucket_key: tuple
    batch_size: int
    max_batch: int
    real_nnz: int          # sum of un-padded nnz over the batch
    padded_nnz: int        # batch_size * bucket nnz_cap
    wall_s: float
    trigger: str           # 'max_batch' | 'max_wait' | 'aging' | 'forced'
    cache_hits: int        # window-function cache hit delta for this flush
    cache_misses: int


class ServiceMetrics:
    """Accumulates per-request and per-batch events; ``snapshot()`` is the
    read side."""

    def __init__(self, window: int = 4096,
                 slo: "obs_health.SLOPolicy | None" = None):
        # Guards every non-stream field below.  Writers (scheduler
        # threads) and readers (snapshot from dashboard/bench threads)
        # may run concurrently; without this lock snapshot() could see
        # torn aggregates (e.g. completed bumped but latencies not yet
        # extended) or race dict resizes in _density.
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.batch_count = 0
        self.latencies_s: collections.deque = collections.deque(
            maxlen=window)
        # Per-bucket latency windows for the per-bucket p99 SLO targets;
        # same sliding-window discipline as the global deque.
        self._window = int(window)
        self._bucket_lat: dict[tuple, collections.deque] = {}
        self.batches: collections.deque = collections.deque(maxlen=window)
        self.t_first_submit: float | None = None
        self.t_last_complete: float | None = None
        self._real_nnz = 0
        self._padded_nnz = 0
        self._cache_hits = 0
        self._cache_misses = 0
        self._occupancy_sum = 0.0
        self._triggers = collections.Counter()
        # Double-buffer dispatch gauges: one record per device
        # dispatch (flush device-half), split into host-assembly seconds,
        # device-execute seconds, and how much of the assembly overlapped
        # some OTHER flush's execute interval (the double-buffer witness).
        self._dispatches = 0
        self._assembly_s = 0.0
        self._execute_s = 0.0
        self._overlap_s = 0.0
        self._device_dispatches = collections.Counter()
        # bucket key -> list of per-mode EWMA row-density profiles
        self._density: dict[tuple, list[np.ndarray]] = {}
        # Queue gauges: the scheduler refreshes these on every
        # submit/poll/flush — current pending depth, age of the oldest
        # queued request, and their uptime peaks (the saturation SLOs).
        self._queue_depth = 0
        self._queue_age_s = 0.0
        self._queue_peak_depth = 0
        self._queue_peak_age_s = 0.0
        # session id -> per-session streaming gauges (own lock: sessions
        # record from outside the scheduler's critical section)
        self._streams: dict[str, dict] = {}
        self._streams_lock = threading.Lock()
        # SLO health: evaluated over the snapshot view; the monitor
        # edge-triggers health.breach/health.clear trace events.  No
        # policy -> the health section reports "disabled".
        self.slo = slo
        self._health = (obs_health.HealthMonitor(slo)
                        if slo is not None else None)

    # -- write side (own lock; callers need hold nothing) -------------------

    def record_submit(self, now: float):
        with self._lock:
            self.submitted += 1
            if self.t_first_submit is None:
                self.t_first_submit = now

    def record_batch(self, event: BatchEvent, latencies_s: list[float],
                     now: float):
        with self._lock:
            self.batches.append(event)
            self.batch_count += 1
            self.completed += event.batch_size
            self.latencies_s.extend(latencies_s)
            blat = self._bucket_lat.get(event.bucket_key)
            if blat is None:
                blat = self._bucket_lat[event.bucket_key] = \
                    collections.deque(maxlen=self._window)
            blat.extend(latencies_s)
            self.t_last_complete = now
            self._real_nnz += event.real_nnz
            self._padded_nnz += event.padded_nnz
            self._cache_hits += event.cache_hits
            self._cache_misses += event.cache_misses
            if event.max_batch:
                self._occupancy_sum += event.batch_size / event.max_batch
            self._triggers[event.trigger] += 1

    def record_dispatch(self, *, devices: list[int], assembly_s: float,
                        execute_s: float, overlap_s: float):
        """Fold one flush's dispatch timing into the dispatch gauges.
        ``devices`` lists the device ids the dispatch ran on (``[0]`` on
        the single-device engine); ``overlap_s``
        is the part of this flush's host assembly that ran while another
        flush's device half was executing."""
        with self._lock:
            self._dispatches += 1
            self._assembly_s += float(assembly_s)
            self._execute_s += float(execute_s)
            self._overlap_s += float(overlap_s)
            for d in devices:
                self._device_dispatches[int(d)] += 1

    def record_queue(self, depth: int, oldest_age_s: float):
        """Refresh the queue-saturation gauges (current pending depth +
        oldest queued request's age).  The scheduler calls this on every
        submit/poll/flush, so the gauge tracks the live queue; peaks are
        running maxima over the whole uptime."""
        with self._lock:
            self._queue_depth = int(depth)
            self._queue_age_s = float(oldest_age_s)
            self._queue_peak_depth = max(self._queue_peak_depth,
                                         self._queue_depth)
            self._queue_peak_age_s = max(self._queue_peak_age_s,
                                         self._queue_age_s)

    def record_density(self, bucket_key: tuple,
                       profiles: tuple[tuple[float, ...] | None, ...]):
        """EWMA-fold one flushed batch's observed per-mode row-density
        profiles into the bucket's running estimate.  A ``None`` profile
        (mode too large to profile cheaply) leaves that mode on the
        uniform prior."""
        with self._lock:
            cur = self._density.get(bucket_key)
            if cur is None:
                self._density[bucket_key] = [
                    None if p is None else np.asarray(p, dtype=np.float64)
                    for p in profiles]
                return
            for d, p in enumerate(profiles):
                if p is None:
                    continue
                if cur[d] is None:
                    cur[d] = np.asarray(p, dtype=np.float64)
                else:
                    cur[d] = (
                        (1.0 - _DENSITY_EWMA) * cur[d]
                        + _DENSITY_EWMA * np.asarray(p, dtype=np.float64))

    def row_density(self, bucket_key: tuple) -> tuple | None:
        """Quantized per-mode density profiles for ``plan_bucket`` (None
        until the bucket has flushed at least once; per-mode None where
        never profiled).  Quantizing to a 1/16 grid keeps the profile
        hashable AND bounds the number of distinct plans (hence
        executables) a drifting stream can induce."""
        with self._lock:
            cur = self._density.get(bucket_key)
            if cur is None:
                return None
            out = []
            for p in cur:
                if p is None:
                    out.append(None)
                    continue
                q = np.round(p / _DENSITY_QUANTUM) * _DENSITY_QUANTUM
                out.append(tuple(float(x) for x in q))
            return tuple(out)

    def record_stream_increment(self, session_id: str, *, bucket_cap: int,
                                nnz: int, evicted: int, wall_s: float,
                                merge_s: float, window: int = 512,
                                count: bool = True):
        """Fold one streaming update into the session's gauges: current
        bucket residency (cap + live nnz), cumulative increment/eviction
        counts, host-merge seconds, and a sliding window of increment
        wall times for the latency percentiles.  ``count=False``
        registers/refreshes the residency gauges without counting an
        increment or recording latency — the cold ``start()`` fit, whose
        compile-heavy wall time would poison the increment percentiles."""
        with self._streams_lock:
            s = self._streams.get(session_id)
            if s is None:
                s = self._streams[session_id] = {
                    "increments": 0, "evictions": 0, "merge_s": 0.0,
                    "lat": collections.deque(maxlen=window),
                }
            s["bucket_cap"] = int(bucket_cap)
            s["nnz"] = int(nnz)
            s["merge_s"] += float(merge_s)
            if count:
                s["increments"] += 1
                s["evictions"] += int(evicted)
                s["lat"].append(float(wall_s))

    # -- read side ----------------------------------------------------------

    def snapshot(self) -> dict:
        # Main state under self._lock; the stream gauges are appended
        # after releasing it (their own lock) so the two are never
        # nested.
        with self._lock:
            lat = np.asarray(self.latencies_s, dtype=np.float64)
            real, padded = self._real_nnz, self._padded_nnz
            hits, misses = self._cache_hits, self._cache_misses
            span = 0.0
            if (self.t_first_submit is not None
                    and self.t_last_complete is not None):
                span = max(self.t_last_complete - self.t_first_submit, 0.0)
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "batches": self.batch_count,
                "throughput_rps": self.completed / span if span > 0 else 0.0,
                "latency_p50_s": (float(np.percentile(lat, 50))
                                  if lat.size else 0.0),
                "latency_p99_s": (float(np.percentile(lat, 99))
                                  if lat.size else 0.0),
                # str(bucket.key) -> windowed p99, for the per-bucket
                # latency SLO targets (and dashboards)
                "bucket_latency_p99_s": {
                    str(k): float(np.percentile(
                        np.asarray(d, dtype=np.float64), 99))
                    for k, d in self._bucket_lat.items() if len(d)
                },
                "queue": {
                    "depth": self._queue_depth,
                    "oldest_age_s": self._queue_age_s,
                    "peak_depth": self._queue_peak_depth,
                    "peak_age_s": self._queue_peak_age_s,
                },
                # fraction of device nnz-slots spent on zero padding
                "padding_overhead": (padded - real) / padded if padded
                else 0.0,
                "batch_occupancy": (self._occupancy_sum / self.batch_count
                                    if self.batch_count else 0.0),
                "cache_hits": hits,
                "cache_misses": misses,
                "cache_hit_rate": (hits / (hits + misses)
                                   if hits + misses else 0.0),
                "density_tracked_buckets": len(self._density),
                "flush_triggers": {
                    t: self._triggers.get(t, 0)
                    for t in ("max_batch", "max_wait", "aging", "forced")
                },
                "dispatch": {
                    "count": self._dispatches,
                    "assembly_s": self._assembly_s,
                    "execute_s": self._execute_s,
                    "overlap_s": self._overlap_s,
                    # fraction of host assembly time hidden behind device
                    # compute — 0 without double buffering, > 0 once the
                    # executor pipelines flushes
                    "overlap_fraction": (self._overlap_s / self._assembly_s
                                         if self._assembly_s > 0 else 0.0),
                    # fraction of service uptime the device(s) spent
                    # executing dispatches
                    "device_occupancy": (self._execute_s / span
                                         if span > 0 else 0.0),
                    "device_dispatches": dict(
                        sorted(self._device_dispatches.items())),
                },
            }
        out["streams"] = self._stream_snapshot()
        # Health last: the evaluator reads the snapshot view itself (a
        # consistent copy — no locks held), so the report always judges
        # exactly the gauges this snapshot exposes.  Breach onsets emit
        # health.breach trace events (edge-triggered, see obs.health).
        if self._health is None:
            out["health"] = {"status": "disabled", "checked": 0,
                             "breaches": []}
        else:
            out["health"] = self._health.observe(out)
        return out

    def _stream_snapshot(self) -> dict:
        with self._streams_lock:
            out = {}
            for sid, s in self._streams.items():
                lat = np.asarray(s["lat"], dtype=np.float64)
                out[sid] = {
                    "bucket_cap": s.get("bucket_cap", 0),
                    "nnz": s.get("nnz", 0),
                    "increments": s["increments"],
                    "evictions": s["evictions"],
                    "merge_s": s["merge_s"],
                    "increment_p50_s": (float(np.percentile(lat, 50))
                                        if lat.size else 0.0),
                    "increment_p99_s": (float(np.percentile(lat, 99))
                                        if lat.size else 0.0),
                }
            return out
