"""Launchers of the port (part of ``repro.launch``): meshes over
``torch.distributed`` ranks (the 1-D part of ``repro.launch.mesh``:
``Mesh``, ``make_mesh``, ``make_batch_mesh``, ``make_host_mesh``, the
rank bootstrap ``init_ranks`` and ``spawn_ranks``, which runs a function
on κ spawned ranks), the train, prefill and decode steps (``steps``),
the sharding rules over a mesh (``shardings``), the LM launchers
(``train`` and ``serve``), the H100 table ``HW`` and the production
meshes (``make_production_mesh``, abstract), and the dry run over them
(``dryrun``, with its counts and roofline in ``op_analysis``).  The
modules after ``mesh`` are imported when first asked for, so ``python
-m repro_torch.launch.train`` runs the module once."""
import importlib

from .mesh import (AXIS, BATCH_AXIS, HW, AbstractMesh, Mesh, backend_for,
                   init_ranks, make_batch_mesh, make_host_mesh, make_mesh,
                   make_production_mesh, spawn_ranks)

_LAZY = ("dryrun", "op_analysis", "serve", "shardings", "steps", "train")

# The one module whose name differs from the reference's: the reference
# analyses compiled HLO, the port counts the operations it dispatches.
FROM_REFERENCE = {"hlo_analysis": "op_analysis"}

__all__ = ["AXIS", "BATCH_AXIS", "HW", "AbstractMesh", "Mesh", "backend_for",
           "dryrun", "init_ranks", "make_batch_mesh", "make_host_mesh",
           "make_mesh", "make_production_mesh", "op_analysis", "serve",
           "shardings", "spawn_ranks", "steps", "train"]


def __getattr__(name):
    if name in _LAZY:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
