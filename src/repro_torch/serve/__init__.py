"""Batched decomposition service (port of ``repro.serve``).

  buckets        -- (shape, nnz cap, method) classes and the padding
                    helpers, bitwise the reference's.
  batched_engine -- B bucket-mates decomposed in lockstep: one launch of
                    the batched MTTKRP kernel per mode and sweep, per-lane
                    freeze masks and convergence, one host read per window;
                    a prepare/execute seam with uploads on a copy stream;
                    the pod path over a batch mesh (``mesh=``, one host
                    read per batch).
  scheduler      -- per-bucket queues, futures, score-based flushes
                    (max-batch, max-wait, aging, forced), row-density
                    feedback into the bucket plan, double-buffered
                    dispatch on one worker thread.
  metrics        -- throughput, p50/p99 latency, padding overhead, batch
                    occupancy, cache hit rates, dispatch overlap,
                    streaming-session gauges, SLO health.

``runtime.ALSRunner`` fronts this service.  ``DecompositionService(mesh=)``
runs its flushes on the pod path; over several ranks, rank 0 is the
controller that takes the requests and broadcasts each flush to the other
ranks, which serve it in ``drain()``.
"""
from .batched_engine import BatchedEngine, batched_cache_stats
from .buckets import Bucket, BucketPolicy, pad_tensor, pad_weights, repeat_pad
from .metrics import BatchEvent, ServiceMetrics
from .scheduler import (BatchScheduler, DecompositionFuture,
                        DecompositionService)

__all__ = [
    "Bucket", "BucketPolicy", "pad_tensor", "pad_weights", "repeat_pad",
    "BatchedEngine", "batched_cache_stats",
    "BatchScheduler", "DecompositionFuture", "DecompositionService",
    "BatchEvent", "ServiceMetrics",
]
