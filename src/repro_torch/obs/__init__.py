"""Observability for the port (port of ``repro.obs``).

  clock     -- the one monotonic-clock front door (``perf_counter``).
  trace     -- the span/event recorder: front-door calls, planning,
               window dispatches and their MTTKRP, update and fit stages,
               service flushes and dispatches, and streaming increments
               report into the active tracer when one is installed;
               JSONL and Chrome-trace export.  Spans measure host time,
               and also go to a recording ``torch.profiler`` (a tracer
               installed or not), where the kernels queued inside each
               count as its device time.
  ledger    -- the build ledger (``LEDGER``): every cache of built window
               functions registers its builds, the port's counterpart of
               the reference's retrace ledger.
  health    -- serving SLO targets judged against ``ServiceMetrics``
               snapshots, with edge-triggered ``health.breach`` events.
  calibrate -- measured per-mode MTTKRP time, shard imbalance and the
               build-vs-steady window split, and the fit of the Hopper
               tile model (``kernels.ops.estimate_pack_cost``).
  history, regress, report -- the benchmark-history ledger, the
               noise-aware regression gate and the terminal dashboard
               (pure stdlib copies of the reference's).

``calibrate`` imports the rest of the port and ``history`` / ``regress``
/ ``report`` are ``python -m`` entry points, so none of them is imported
here eagerly.
"""
from . import clock, health, trace  # noqa: F401
from .ledger import LEDGER, RetraceLedger  # noqa: F401
from .trace import (Tracer, active, capture, disable, enable, event,  # noqa: F401
                    load_jsonl, sink, span, validate_chrome)

__all__ = [
    "clock", "health", "trace", "LEDGER", "RetraceLedger", "Tracer",
    "active", "capture", "disable", "enable", "event", "load_jsonl", "sink",
    "span", "validate_chrome",
]
