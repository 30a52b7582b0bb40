"""Runtime front doors (port of ``repro.runtime``, less the LM trainer)."""
from .trainer import ALSRunner, StragglerMonitor

__all__ = ["ALSRunner", "StragglerMonitor"]
