"""Decomposition methods on one MTTKRP substrate (port of ``repro.methods``).

  registry -- ``MethodSpec`` catalogue; ``cpd_als(method=...)`` and the
              batched service route by name, and ``serve.buckets`` keys
              request classes on (shape, nnz cap, method).
  plain    -- unconstrained CP-ALS ('cp', the substrate's inline update).
  nncp     -- nonnegative CP via HALS: factors >= 0, fit nondecreasing.
  masked   -- masked/weighted CP completion: EM residual MTTKRP through the
              valued kernel entry plus a closed-form dense term, weighted
              observed-entry fit, user-supplied per-entry weights.

A method is a per-mode update rule (and, for 'masked', the values its
MTTKRP runs on) against ``core.als_device.SweepContext``; the sweep, the
window, the caches and the batched service are shared.  The reference's
stateful 'streaming' method is not ported yet.
"""
from .registry import (MethodSpec, batchable_methods, get_method,
                       list_methods, register_method)
from . import plain as _plain          # noqa: F401  (registers 'cp')
from . import nncp as _nncp            # noqa: F401  (registers 'nncp')
from . import masked as _masked        # noqa: F401  (registers 'masked')

__all__ = [
    "MethodSpec", "register_method", "get_method", "list_methods",
    "batchable_methods",
]
