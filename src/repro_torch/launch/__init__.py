"""Meshes over ``torch.distributed`` ranks (port of the 1-D part of
``repro.launch.mesh``): ``Mesh``, ``make_mesh``, ``make_batch_mesh``, the
rank bootstrap ``init_ranks`` and ``spawn_ranks``, which runs a function
on κ spawned ranks."""
from .mesh import (AXIS, BATCH_AXIS, Mesh, backend_for, init_ranks,
                   make_batch_mesh, make_mesh, spawn_ranks)

__all__ = ["AXIS", "BATCH_AXIS", "Mesh", "backend_for", "init_ranks",
           "make_batch_mesh", "make_mesh", "spawn_ranks"]
