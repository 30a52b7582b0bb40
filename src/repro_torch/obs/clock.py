"""One clock front door for every layer.

Durations MUST be measured with ``now()`` (``time.perf_counter`` — the
highest-resolution monotonic clock; immune to wall-clock steps from NTP
or suspend, unlike ``time.time``).  ``wall()`` is the epoch clock, for
*timestamps* only (checkpoint metadata, trace-export epoch anchoring) —
never subtract two ``wall()`` readings to time something.

``process()`` (``time.process_time``) measures CPU time consumed by the
process — the span recorder stores both so a trace can separate
wall-blocked time (device dispatch, lock waits) from host compute.

These are aliases, not wrappers: the hot paths that guard on the active
tracer pay no extra Python frame for reading the clock.
"""
from __future__ import annotations

import time

now = time.perf_counter
process = time.process_time
wall = time.time
