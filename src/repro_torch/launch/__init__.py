"""Launchers of the port (part of ``repro.launch``): meshes over
``torch.distributed`` ranks (the 1-D part of ``repro.launch.mesh``:
``Mesh``, ``make_mesh``, ``make_batch_mesh``, the rank bootstrap
``init_ranks`` and ``spawn_ranks``, which runs a function on κ spawned
ranks), the serving steps (``steps``) and the LM serving launcher
(``serve``).  ``serve`` and ``steps`` are imported when first asked
for, so ``python -m repro_torch.launch.serve`` runs the module once."""
import importlib

from .mesh import (AXIS, BATCH_AXIS, Mesh, backend_for, init_ranks,
                   make_batch_mesh, make_mesh, spawn_ranks)

__all__ = ["AXIS", "BATCH_AXIS", "Mesh", "backend_for", "init_ranks",
           "make_batch_mesh", "make_mesh", "serve", "spawn_ranks", "steps"]


def __getattr__(name):
    if name in ("serve", "steps"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
