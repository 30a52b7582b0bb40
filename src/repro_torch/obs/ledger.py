"""The build ledger: one registry for every cache of built window
functions (port of ``repro.obs.ledger``'s ``RetraceLedger``).

The reference counts XLA traces of its jitted executables.  The port
compiles nothing per shape: its window functions are Python closures
over PyTorch ops and the slab kernel, built once per cache key.  A
*trace* in the port is therefore a **build**: a miss of one of its
``functools.lru_cache`` builders, each of which registers what it built
here:

  * ``core.als_device._build_sweep_block``        -- kind ``sweep_block``
  * ``core.als_device._build_mttkrp_block``       -- kind ``mttkrp_block``
  * ``serve.batched_engine._build_batched_block`` -- kind ``batched_block``
  * ``obs.calibrate._mode_mttkrp_fn``             -- kind ``calibrate_mode``

(the reference's pod and distributed kinds arrive with those paths).  A
novel key adds one build and a repeated key adds none; the numbers need
not equal the reference's ``traces``, which also count re-specialization
inside one key.  ``reset()`` re-baselines the counts, ``isolated()``
scopes them, and every registration emits a ``ledger.compile`` trace
event, so a trace alone tells which functions were built.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Iterator

from . import trace as _trace

__all__ = ["RetraceLedger", "LEDGER"]


class RetraceLedger:
    """Thread-safe registry of (kind, key) -> built function, with a
    build count per entry."""

    def __init__(self):
        self._lock = threading.Lock()
        # (kind, key) -> {"fn": fn, "builds": int, "baseline": int}
        self._entries: dict[tuple[str, str], dict] = {}
        # keys registered since the last reset()
        self._new: set[tuple[str, str]] = set()

    # -- write side ---------------------------------------------------------

    def register(self, kind: str, key: Any, fn: Any) -> Any:
        """Record one build of ``(kind, key)``.  Called from inside the
        lru-cached builders, so a key registers once per process unless
        its cache is cleared.  Emits a ``ledger.compile`` trace event.
        Returns ``fn`` for chaining."""
        k = (kind, str(key))
        with self._lock:
            entry = self._entries.setdefault(k, {"fn": fn, "builds": 0,
                                                 "baseline": 0})
            entry["fn"] = fn
            entry["builds"] += 1
            self._new.add(k)
        _trace.event("ledger.compile", cat="compile", kind=kind,
                     key=str(key))
        return fn

    def reset(self) -> None:
        """Re-baseline: build counts and the new-entry set read as zero
        after this.  Entries are kept (their functions stay alive in the
        builders' caches regardless)."""
        with self._lock:
            for entry in self._entries.values():
                entry["baseline"] = entry["builds"]
            self._new.clear()

    @contextmanager
    def isolated(self) -> Iterator["RetraceLedger"]:
        """Scoped isolation: reset on entry and exit, so the counts read
        inside the block are the block's own."""
        self.reset()
        try:
            yield self
        finally:
            self.reset()

    # -- read side ----------------------------------------------------------

    def stats(self, kind: str | None = None) -> dict:
        """``{"blocks", "blocks_new", "traces"}`` for one kind (or all):
        registered functions, those registered since the last
        ``reset()``, and builds since the last ``reset()``."""
        with self._lock:
            items = [(k, e) for k, e in self._entries.items()
                     if kind is None or k[0] == kind]
            new = sum(1 for k, _ in items if k in self._new)
            builds = sum(e["builds"] - e["baseline"] for _, e in items)
        return {"blocks": len(items), "blocks_new": new, "traces": builds}

    def entries(self, kind: str | None = None) -> list[dict]:
        """Per-function rows for the report: kind, key, builds since the
        last ``reset()``."""
        with self._lock:
            items = sorted(
                (k, e["builds"] - e["baseline"]) for k, e in self._entries.items()
                if kind is None or k[0] == kind)
        return [{"kind": knd, "key": key, "traces": n}
                for (knd, key), n in items]

    def kinds(self) -> list[str]:
        with self._lock:
            return sorted({k for k, _ in self._entries})


#: The process-wide ledger every builder registers into.
LEDGER = RetraceLedger()
