"""Batched decomposition service, single device (port of ``repro.serve``).

  buckets        -- (shape, nnz cap, method) classes and the padding
                    helpers, bitwise the reference's.
  batched_engine -- B bucket-mates decomposed in lockstep: one launch of
                    the batched MTTKRP kernel per mode and sweep, per-lane
                    freeze masks and convergence, one host read per window.

The reference's scheduler, metrics and pod path are not ported yet.
"""
from .batched_engine import BatchedEngine, batched_cache_stats
from .buckets import Bucket, BucketPolicy, pad_tensor, pad_weights, repeat_pad

__all__ = [
    "Bucket", "BucketPolicy", "pad_tensor", "pad_weights", "repeat_pad",
    "BatchedEngine", "batched_cache_stats",
]
