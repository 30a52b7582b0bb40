"""Live serving SLO health: policy, evaluator, edge-triggered breaches
(port of ``repro.obs.health``).

``SLOPolicy`` names the targets a running decomposition service is held
to — per-bucket (and global) p99 request latency, queue depth/age,
cache-hit / double-buffer-overlap / batch-occupancy floors, and a
streaming-increment p99 ceiling.  ``evaluate`` is a pure function from
(policy, gauge view) to a health report; ``HealthMonitor`` wraps it with
edge-triggered ``health.breach`` trace events (one per breach *onset*,
through ``obs.trace``, so a JSONL trace alone reconstructs when each SLO
first went red and ``health.clear`` when it recovered).

The gauge view is the dict shape ``ServiceMetrics.snapshot()`` produces
(which is where the serving tier wires this in — ``snapshot()["health"]``)
but the evaluator itself only reads plain keys, so any caller with
numbers — e.g. the LM serving launcher gating decode latency — can build
a view by hand.

Floors (hit rate, occupancy, overlap) only arm once ``min_events``
batches have completed: a cold service's first flush always misses the
executable cache, and judging a floor on one event is noise, not health.

Pure-stdlib module (plus ``obs.trace``), importable everywhere.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Mapping

from . import trace as obs_trace

__all__ = ["SLOPolicy", "Breach", "evaluate", "HealthMonitor"]


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Targets; ``None`` disables a given SLO.  Latency/age knobs are
    ceilings, ``*_min`` knobs are floors."""

    latency_p99_s: float | None = None
    # str(bucket.key) -> per-bucket p99 ceiling; buckets without an
    # entry fall back to the global latency_p99_s.
    bucket_latency_p99_s: Mapping[str, float] | None = None
    queue_depth: int | None = None
    queue_age_s: float | None = None
    cache_hit_rate_min: float | None = None
    overlap_fraction_min: float | None = None
    batch_occupancy_min: float | None = None
    stream_increment_p99_s: float | None = None
    # Floors arm only after this many completed requests (cold-start
    # flushes always miss the cache; one event is noise).
    min_events: int = 8


@dataclasses.dataclass(frozen=True)
class Breach:
    """One violated SLO.  ``scope`` narrows it (bucket key, session id,
    or "service"); ``kind`` is "ceiling" or "floor"."""

    slo: str
    scope: str
    kind: str
    target: float
    observed: float

    def key(self) -> tuple[str, str]:
        return (self.slo, self.scope)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _ceiling(breaches: list[Breach], slo: str, scope: str,
             target: float | None, observed: float | None) -> None:
    if target is not None and observed is not None and observed > target:
        breaches.append(Breach(slo, scope, "ceiling", float(target),
                               float(observed)))


def _floor(breaches: list[Breach], slo: str, scope: str,
           target: float | None, observed: float | None) -> None:
    if target is not None and observed is not None and observed < target:
        breaches.append(Breach(slo, scope, "floor", float(target),
                               float(observed)))


def evaluate(policy: SLOPolicy, view: Mapping) -> dict:
    """Judge one gauge view against the policy.

    ``view`` keys read (all optional — an absent gauge is not judged):
    ``latency_p99_s``, ``bucket_latency_p99_s`` ({bucket: p99}),
    ``queue`` ({depth, oldest_age_s}), ``completed``, ``cache_hit_rate``,
    ``batch_occupancy``, ``dispatch`` ({count, overlap_fraction}),
    ``streams`` ({session: {increment_p99_s}}).

    Returns ``{"status": "ok"|"breach", "breaches": [breach dicts],
    "checked": n}`` — ``checked`` counts the SLOs that actually armed,
    so a green report on a cold service is distinguishable from one
    that judged nothing.
    """
    breaches: list[Breach] = []
    checked = 0
    completed = int(view.get("completed") or 0)
    warm = completed >= policy.min_events

    # -- latency ceilings ---------------------------------------------------
    if (policy.latency_p99_s is not None and completed > 0
            and view.get("latency_p99_s") is not None):
        checked += 1
        _ceiling(breaches, "latency_p99_s", "service",
                 policy.latency_p99_s, view.get("latency_p99_s"))
    per_bucket = view.get("bucket_latency_p99_s") or {}
    targets = policy.bucket_latency_p99_s or {}
    if (targets or policy.latency_p99_s is not None) and per_bucket:
        for bucket, p99 in per_bucket.items():
            target = targets.get(bucket, policy.latency_p99_s)
            if target is None:
                continue
            checked += 1
            _ceiling(breaches, "bucket_latency_p99_s", str(bucket),
                     target, p99)

    # -- queue ceilings (judged even cold: a saturated queue IS the
    # cold-start failure mode) ---------------------------------------------
    queue = view.get("queue") or {}
    if policy.queue_depth is not None and "depth" in queue:
        checked += 1
        _ceiling(breaches, "queue_depth", "service",
                 float(policy.queue_depth), queue.get("depth"))
    if policy.queue_age_s is not None and "oldest_age_s" in queue:
        checked += 1
        _ceiling(breaches, "queue_age_s", "service",
                 policy.queue_age_s, queue.get("oldest_age_s"))

    # -- floors (armed only warm) ------------------------------------------
    if warm:
        if (policy.cache_hit_rate_min is not None
                and view.get("cache_hit_rate") is not None):
            checked += 1
            _floor(breaches, "cache_hit_rate", "service",
                   policy.cache_hit_rate_min, view.get("cache_hit_rate"))
        if (policy.batch_occupancy_min is not None
                and view.get("batch_occupancy") is not None):
            checked += 1
            _floor(breaches, "batch_occupancy", "service",
                   policy.batch_occupancy_min, view.get("batch_occupancy"))
        dispatch = view.get("dispatch") or {}
        if (policy.overlap_fraction_min is not None
                and int(dispatch.get("count") or 0) >= policy.min_events):
            checked += 1
            _floor(breaches, "overlap_fraction", "service",
                   policy.overlap_fraction_min,
                   dispatch.get("overlap_fraction"))

    # -- streaming sessions -------------------------------------------------
    if policy.stream_increment_p99_s is not None:
        for sid, s in (view.get("streams") or {}).items():
            if int(s.get("increments") or 0) < 1:
                continue
            checked += 1
            _ceiling(breaches, "stream_increment_p99_s", str(sid),
                     policy.stream_increment_p99_s,
                     s.get("increment_p99_s"))

    return {
        "status": "breach" if breaches else "ok",
        "checked": checked,
        "breaches": [b.as_dict() for b in breaches],
    }


class HealthMonitor:
    """Stateful wrapper: evaluates a view and emits edge-triggered
    ``health.breach`` / ``health.clear`` trace events — one per breach
    onset/recovery, not per evaluation, so a long-red SLO doesn't flood
    the trace.  Thread-safe (snapshot() is callable from any thread)."""

    def __init__(self, policy: SLOPolicy):
        self.policy = policy
        self._lock = threading.Lock()
        self._active: dict[tuple[str, str], Breach] = {}

    def observe(self, view: Mapping) -> dict:
        report = evaluate(self.policy, view)
        breaches = {(b["slo"], b["scope"]): b for b in report["breaches"]}
        with self._lock:
            new = [b for k, b in breaches.items() if k not in self._active]
            cleared = [b for k, b in self._active.items()
                       if k not in breaches]
            self._active = {k: Breach(**b) for k, b in breaches.items()}
        for b in new:
            obs_trace.event("health.breach", cat="health", **b)
        for b in cleared:
            obs_trace.event("health.clear", cat="health", slo=b.slo,
                            scope=b.scope)
        return report

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
