"""Low-overhead structured span/event recorder (port of ``repro.obs.trace``).

Design constraints, in priority order:

1. **Disabled is free.**  There is no global "maybe trace" wrapper on the
   hot paths; instrumented call sites do::

       tr = trace.sink()
       if tr is None:
           ... dispatch ...          # zero obs allocations
       else:
           with tr.span("als.window", cat="als", window=k):
               ... dispatch ...

   ``sink()`` is one module-global read plus one profiler check — no
   locks, no closures, no kwargs dict on the disabled branch.  A test
   asserts the disabled path adds zero allocations per dispatch.
2. **Records are plain dicts.**  One dict per finished span/event,
   appended to an in-memory list (CPython list.append is atomic under
   the GIL, so recording from scheduler/session threads needs no lock).
   Span nesting is tracked per thread via ``threading.local`` stacks.
3. **Two export shapes from the same records.**  JSONL (one record per
   line, greppable) and Chrome
   ``trace_event`` JSON (``{"traceEvents": [...]}`` with ``ph: "X"``
   complete events in microseconds — drop it into ``about:tracing`` or
   https://ui.perfetto.dev).

Every span carries wall-clock duration (``perf_counter``), process-CPU
duration (``process_time``), thread id, and arbitrary key-value attrs
(set at creation or via ``span.set(...)`` while open).  Timestamps are
offsets from the tracer's start on the monotonic clock; the epoch anchor
(``t0_wall``) is kept once in the tracer meta so exports can reconstruct
absolute times without any wall-clock subtraction in the measurement
path.

Spans measure host time.  On the card a span around queued work closes
when the host has queued it, not when the device has run it.  Device time
comes from ``torch.profiler``, the spans' second sink: a span opened while
a profiler records (Tracer installed or not) also opens a profiler record
of the same name for as long as it is open, so the spans sit among the
profiler's host events on its clock, and the kernels queued inside a span
count in that record's ``FunctionEvent.device_time_total``.  The record
has the profiler's function scope, as an operator's has (the scope
``torch.profiler.record_function`` gives is the user scope, whose
records the profiler does not link kernels to): a kernel launched by the
span's own code, outside any operator (the slab kernel's ctypes launch),
is then linked to the span.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
from typing import IO, Any, Iterator

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

from . import clock

__all__ = [
    "Tracer", "Span", "active", "sink", "enable", "disable", "capture",
    "span", "event", "load_jsonl", "validate_chrome",
]


def _profiler_record(name: str):
    """A profiler record named ``name``, entered, while a
    ``torch.profiler`` records on this thread; else None."""
    if not _profiler_enabled():
        return None
    record = _RecordFunctionFast(name)
    record.__enter__()
    return record


class Span:
    """An open span; a context manager.  ``set(**attrs)`` attaches
    key-value attrs any time before exit.  The record is appended to the
    tracer only when the span closes."""

    __slots__ = ("_tracer", "name", "cat", "args", "id", "parent", "tid",
                 "t0", "_p0", "_stack", "_record")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.id = next(tracer._ids)
        self.tid = threading.get_ident()
        self._stack = tracer._thread_stack()
        self.parent = self._stack[-1].id if self._stack else None
        self._p0 = clock.process()
        self.t0 = clock.now()

    def set(self, **attrs: Any) -> "Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._stack.append(self)
        self._record = _profiler_record(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = clock.now()
        p1 = clock.process()
        if self._record is not None:
            self._record.__exit__(exc_type, exc, tb)
        stack = self._stack
        # Tolerate exits out of creation order (mis-nested user code):
        # remove self wherever it is rather than corrupting the stack.
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # pragma: no cover - defensive
            stack.remove(self)
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer._records.append({
            "kind": "span",
            "id": self.id,
            "parent": self.parent,
            "name": self.name,
            "cat": self.cat,
            "tid": self.tid,
            "ts_us": (self.t0 - self._tracer.t0) * 1e6,
            "dur_us": (t1 - self.t0) * 1e6,
            "proc_us": (p1 - self._p0) * 1e6,
            "args": self.args,
        })
        return False


class Tracer:
    """Collects span/event records in memory; export with
    ``dump_jsonl`` / ``dump_chrome`` (or read ``records()`` directly)."""

    def __init__(self, name: str = "repro_torch"):
        self.name = name
        self.t0 = clock.now()
        self.t0_wall = clock.wall()
        self.pid = os.getpid()
        self._ids = itertools.count()
        self._records: list[dict] = []
        self._tls = threading.local()

    # -- recording ----------------------------------------------------------

    def _thread_stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, cat: str = "app", **attrs: Any) -> Span:
        """Open a span.  Use as a context manager; nesting is inferred
        from the per-thread stack of open spans."""
        return Span(self, name, cat, attrs)

    def event(self, name: str, cat: str = "app", **attrs: Any) -> None:
        """Record an instant event (no duration), parented to the
        innermost open span on this thread."""
        stack = self._thread_stack()
        self._records.append({
            "kind": "event",
            "id": next(self._ids),
            "parent": stack[-1].id if stack else None,
            "name": name,
            "cat": cat,
            "tid": threading.get_ident(),
            "ts_us": (clock.now() - self.t0) * 1e6,
            "args": attrs,
        })

    # -- reading / export ---------------------------------------------------

    def records(self) -> list[dict]:
        """The raw records (live list — copy before mutating)."""
        return self._records

    def meta(self) -> dict:
        return {"kind": "meta", "name": self.name, "pid": self.pid,
                "t0_wall": self.t0_wall}

    def dump_jsonl(self, path_or_file: str | IO[str]) -> None:
        """One JSON record per line; first line is the tracer meta."""
        def _write(f: IO[str]) -> None:
            f.write(json.dumps(self.meta()) + "\n")
            for rec in self._records:
                f.write(json.dumps(_jsonable(rec)) + "\n")
        if isinstance(path_or_file, (str, os.PathLike)):
            with open(path_or_file, "w") as f:
                _write(f)
        else:
            _write(path_or_file)

    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` document (``about:tracing`` /
        Perfetto).  Spans become complete ("X") events, instant events
        become "i"; process/thread metadata rides along as "M"."""
        events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
             "args": {"name": self.name}},
        ]
        tids = sorted({r["tid"] for r in self._records})
        for tid in tids:
            events.append({"name": "thread_name", "ph": "M",
                           "pid": self.pid, "tid": tid,
                           "args": {"name": f"thread-{tid}"}})
        for rec in self._records:
            ev = {
                "name": rec["name"],
                "cat": rec.get("cat", "app"),
                "pid": self.pid,
                "tid": rec["tid"],
                "ts": rec["ts_us"],
                "args": _jsonable(rec.get("args", {})),
            }
            if rec["kind"] == "span":
                ev["ph"] = "X"
                ev["dur"] = rec["dur_us"]
                ev["args"]["proc_us"] = rec.get("proc_us")
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"t0_wall": self.t0_wall}}

    def dump_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)


def _jsonable(obj: Any) -> Any:
    """Best-effort conversion of attr values to JSON-serializable types
    (numpy scalars, tuples-as-keys etc. show up in plan attrs)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    item = getattr(obj, "item", None)  # numpy scalars
    if callable(item):
        try:
            return item()
        except Exception:  # pragma: no cover - defensive
            pass
    return str(obj)


# -- module-level switchboard ------------------------------------------------

_ACTIVE: Tracer | None = None


def active() -> Tracer | None:
    """The installed tracer, or None when tracing is disabled."""
    return _ACTIVE


class _ProfilerSpan:
    """A span only a recording ``torch.profiler`` sees (no Tracer is
    installed): the profiler record of its name; attrs are dropped."""

    __slots__ = ("name", "_record")

    def __init__(self, name: str):
        self.name = name
        self._record = None

    def set(self, **attrs: Any) -> "_ProfilerSpan":
        return self

    def __enter__(self) -> "_ProfilerSpan":
        self._record = _profiler_record(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._record is not None:
            self._record.__exit__(exc_type, exc, tb)
        return False


class _ProfilerSink:
    """``sink()``'s answer while a profiler records and no Tracer is
    installed; ``span`` has the Tracer's signature."""

    __slots__ = ()

    def span(self, name: str, cat: str = "app", **attrs: Any) -> _ProfilerSpan:
        return _ProfilerSpan(name)


PROFILER = _ProfilerSink()


def sink() -> Tracer | _ProfilerSink | None:
    """Where a span opened now is recorded: the installed Tracer (its
    spans also reach a recording profiler), else ``PROFILER`` while a
    ``torch.profiler`` records, else None.  Hot paths read this once and
    branch; the None branch is allocation-free."""
    tr = _ACTIVE
    if tr is not None:
        return tr
    return PROFILER if _profiler_enabled() else None


def enable(tracer: Tracer | None = None) -> Tracer:
    """Install (and return) the process-wide tracer."""
    global _ACTIVE
    _ACTIVE = tracer if tracer is not None else Tracer()
    return _ACTIVE


def disable() -> Tracer | None:
    """Uninstall the tracer; returns it so callers can still export."""
    global _ACTIVE
    tr, _ACTIVE = _ACTIVE, None
    return tr


@contextlib.contextmanager
def capture(name: str = "repro_torch") -> Iterator[Tracer]:
    """Scoped tracing: installs a fresh Tracer for the with-block and
    restores the previous state after (the usual test/bench entry)."""
    global _ACTIVE
    prev = _ACTIVE
    tr = Tracer(name)
    _ACTIVE = tr
    try:
        yield tr
    finally:
        _ACTIVE = prev


class _NullSpan:
    """Inert span for convenience call sites when tracing is off."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL = _NullSpan()


def span(name: str, cat: str = "app", **attrs: Any
         ) -> Span | _ProfilerSpan | _NullSpan:
    """Convenience for warm (non-hot) paths: a span in ``sink()`` when
    there is one, an inert one otherwise.  Hot per-dispatch sites should
    use the ``sink()`` guard instead — this form builds a kwargs dict even
    when disabled."""
    tr = sink()
    return tr.span(name, cat, **attrs) if tr is not None else NULL


def event(name: str, cat: str = "app", **attrs: Any) -> None:
    """Convenience: record an instant event iff tracing is on."""
    tr = _ACTIVE
    if tr is not None:
        tr.event(name, cat, **attrs)


# -- loading / validation ----------------------------------------------------

def load_jsonl(path: str) -> list[dict]:
    """Read a JSONL trace back into records (meta line(s) excluded)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") != "meta":
                out.append(rec)
    return out


_CHROME_PHASES = {"X", "i", "M", "B", "E"}


def validate_chrome(doc: dict) -> list[dict]:
    """Validate a Chrome trace_event document; returns the event list.

    Raises ``ValueError`` describing the first violation.  Shared by the
    round-trip tests and the committed-artifact check so the schema is
    asserted in exactly one place.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a Chrome trace: missing 'traceEvents'")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i}: missing '{key}'")
        if ev["ph"] not in _CHROME_PHASES:
            raise ValueError(f"event {i}: unknown phase {ev['ph']!r}")
        if ev["ph"] in ("X", "i"):
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"event {i}: 'ts' must be numeric")
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: 'dur' must be >= 0")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i}: 'args' must be an object")
    return events
