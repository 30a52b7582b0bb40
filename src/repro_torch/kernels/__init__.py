"""Kernels of the port (port of ``repro.kernels``; the same public names
but for the kernel itself, see ``FROM_REFERENCE``).

mttkrp_slab.py — the wrappers of the hand-written Hopper kernel
                 (``csrc/mttkrp_slab.cu``): slab-packed segmented MTTKRP,
                 value-baked (``mttkrp_slab.mttkrp_slab``), valued and
                 batched entries, and their plain PyTorch versions (the
                 CPU path).  The namespace exports this module, where the
                 reference exports its one kernel function.
build.py       — nvcc build and ctypes binding, on the first launch.
ops.py         — host-side slab packing, the packed front door, the
                 Hopper tile model.
ref.py         — pure-torch oracles (dense matricization / COO /
                 sorted-segment formulations).
"""
from . import mttkrp_slab
from .ops import (DEFAULT_BLOCK_ROWS, DEFAULT_TILE, PackedModeLayout,
                  auto_tiles, estimate_pack_cost, mttkrp_packed,
                  mttkrp_packed_ref, pack_layout, pack_slabs)

# The one name that differs from the reference's ``__all__``: its Pallas
# TPU kernel is this package's Hopper kernel module.
FROM_REFERENCE = {"mttkrp_pallas": "mttkrp_slab"}

__all__ = [
    "mttkrp_slab", "DEFAULT_BLOCK_ROWS", "DEFAULT_TILE",
    "PackedModeLayout", "auto_tiles", "estimate_pack_cost",
    "mttkrp_packed", "mttkrp_packed_ref", "pack_layout", "pack_slabs",
]
