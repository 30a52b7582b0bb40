"""Decomposition methods on one MTTKRP substrate (port of ``repro.methods``).

  registry -- ``MethodSpec`` catalogue; ``cpd_als(method=...)`` and the
              batched service route by name, and ``serve.buckets`` keys
              request classes on (shape, nnz cap, method).
  plain    -- unconstrained CP-ALS ('cp', the substrate's inline update).
  nncp     -- nonnegative CP via HALS: factors >= 0, fit nondecreasing.
  masked   -- masked/weighted CP completion: EM residual MTTKRP through the
              valued kernel entry plus a closed-form dense term, weighted
              observed-entry fit, user-supplied per-entry weights.
  streaming -- stateful ``StreamingCP`` session: folds nonzero increments
              into existing factors with warm-started refinement sweeps
              (inner method cp, nncp or masked), bucket-quantized fit
              inputs, an O(nnz + m) sorted merge, decay eviction and
              checkpoint save/restore.

A method is a per-mode update rule (and, for 'masked', the values its
MTTKRP runs on) against ``core.als_device.SweepContext``; the sweep, the
window, the caches and the batched service are shared.  'streaming' is
stateful: a session drives the engines across calls.
"""
from .registry import (MethodSpec, batchable_methods, get_method,
                       list_methods, register_method)
from . import plain as _plain          # noqa: F401  (registers 'cp')
from . import nncp as _nncp            # noqa: F401  (registers 'nncp')
from . import masked as _masked        # noqa: F401  (registers 'masked')
from .streaming import StreamingCP     # (registers 'streaming')

__all__ = [
    "MethodSpec", "register_method", "get_method", "list_methods",
    "batchable_methods", "StreamingCP",
]
