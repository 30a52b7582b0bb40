"""Launchers of the port (part of ``repro.launch``): meshes over
``torch.distributed`` ranks (the 1-D part of ``repro.launch.mesh``:
``Mesh``, ``make_mesh``, ``make_batch_mesh``, ``make_host_mesh``, the
rank bootstrap ``init_ranks`` and ``spawn_ranks``, which runs a function
on κ spawned ranks), the train, prefill and decode steps (``steps``),
the sharding rules over a mesh (``shardings``), and the LM launchers
(``train`` and ``serve``).  ``serve``, ``shardings``, ``steps`` and
``train`` are imported when first asked for, so ``python -m
repro_torch.launch.train`` runs the module once."""
import importlib

from .mesh import (AXIS, BATCH_AXIS, Mesh, backend_for, init_ranks,
                   make_batch_mesh, make_host_mesh, make_mesh, spawn_ranks)

_LAZY = ("serve", "shardings", "steps", "train")

__all__ = ["AXIS", "BATCH_AXIS", "Mesh", "backend_for", "init_ranks",
           "make_batch_mesh", "make_host_mesh", "make_mesh", "serve",
           "shardings", "spawn_ranks", "steps", "train"]


def __getattr__(name):
    if name in _LAZY:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
