"""Runtime front doors (port of ``repro.runtime``): the LM ``Trainer``,
the decomposition front door ``ALSRunner`` and ``StragglerMonitor``."""
from .trainer import ALSRunner, StragglerMonitor, Trainer

__all__ = ["ALSRunner", "StragglerMonitor", "Trainer"]
