"""Observability for the port (port of ``repro.obs``, in part).

  clock  -- the one monotonic-clock front door (``perf_counter``).
  trace  -- the span/event recorder: plan construction, service flushes
            and dispatches, and streaming increments report into the
            active tracer when one is installed; JSONL and Chrome-trace
            export.  Spans measure host time.
  health -- serving SLO targets judged against ``ServiceMetrics``
            snapshots, with edge-triggered ``health.breach`` events.

The reference's retrace ledger, calibration, history, regression gate and
report are not ported yet.
"""
from . import clock, health, trace  # noqa: F401
from .trace import (Tracer, active, capture, disable, enable, event,  # noqa: F401
                    load_jsonl, span, validate_chrome)

__all__ = [
    "clock", "health", "trace", "Tracer", "active", "capture", "disable",
    "enable", "event", "load_jsonl", "span", "validate_chrome",
]
