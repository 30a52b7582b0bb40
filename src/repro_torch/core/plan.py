"""Static-shape partition plans, single-tensor part (port of ``repro.core.plan``).

  * ``quantize_nnz`` -- the nnz cap of a (shape, nnz-bucket) class.
  * ``slab_cap``     -- an nnz-independent upper bound on the packed grid
    size: any tensor with ``nnz <= nnz_cap`` packs into at most
    ``ceil(I_d / block_rows) + nnz_cap // tile`` slabs.
  * ``ModePlan`` / ``PartitionPlan`` -- the per-mode tiling decision.

The tiling is the port's own.  ``(block_rows, tile)`` default to
(128, 256) unless pinned.  ``rank_block`` is the widest rank block whose
pass-one block of the slab kernel, for the mode's number of input
factors, fits the shared memory one block may use on the plan's device
(``kernels.mttkrp_slab.max_rank_block``); the JAX package's TPU cost
model (VMEM and MXU units) is not carried over.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..kernels import ops as kops
from ..kernels.mttkrp_slab import DEFAULT_SMEM_BYTES, max_rank_block


def quantize_nnz(nnz: int, *, mode: str = "quantum", quantum: int = 128,
                 growth: float = 1.25, min_cap: int = 128) -> int:
    """Round ``nnz`` up to its bucket cap.

    mode 'quantum': next multiple of ``quantum``.  mode 'geometric': next
    ``min_cap * growth^k``.
    """
    nnz = max(int(nnz), 1)
    if mode == "quantum":
        q = max(int(quantum), 1)
        return max(-(-nnz // q) * q, min_cap)
    if mode == "geometric":
        cap = float(min_cap)
        while cap < nnz:
            cap *= growth
        return int(np.ceil(cap))
    raise ValueError(f"unknown bucketing mode {mode!r}")


def slab_cap(num_rows: int, nnz_cap: int, block_rows: int, tile: int) -> int:
    """Static upper bound on the packed grid size G for ANY tensor of this
    mode with ``nnz <= nnz_cap``: every row block contributes at least one
    slab and the data at most ``floor(nnz_cap / tile)`` extra full slabs,
    since ``ceil(x / t) <= 1 + floor(x / t)``."""
    nb = max(1, -(-int(num_rows) // int(block_rows)))
    return nb + int(nnz_cap) // int(tile)


@dataclasses.dataclass(frozen=True)
class ModePlan:
    """Static packing/tiling decision for one output mode."""

    mode: int
    num_rows: int
    block_rows: int
    tile: int
    rank_block: int            # rank columns per kernel pass
    num_row_blocks: int
    slab_cap: int              # padded grid size G_cap (static)
    nnz_cap: int

    @property
    def slab_meta(self) -> tuple[int, int, int, int]:
        """The static tuple the fused sweep builder keys its cache on."""
        return (self.num_row_blocks, self.block_rows, self.tile,
                self.rank_block)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """All-modes static plan for one (shape, nnz_cap) class."""

    shape: tuple[int, ...]
    nnz_cap: int
    rank: int
    kappa: int
    modes: tuple[ModePlan, ...]

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    def slab_meta(self) -> tuple:
        return tuple(m.slab_meta for m in self.modes)

    def describe(self) -> str:
        """One-line plan fingerprint."""
        return ";".join(f"m{m.mode}:br{m.block_rows}/t{m.tile}"
                        f"/rb{m.rank_block}/G{m.slab_cap}" for m in self.modes)


def _mode_plan(num_rows: int, mode: int, rank: int, nnz_cap: int, *,
               block_rows: int | None, tile: int | None,
               rank_block: int | None, smem_limit: int,
               num_inputs: int) -> ModePlan:
    block_rows = kops.DEFAULT_BLOCK_ROWS if block_rows is None else int(block_rows)
    tile = kops.DEFAULT_TILE if tile is None else int(tile)
    if rank_block is None:
        rank_block = max_rank_block(block_rows, smem_limit, num_inputs)
        if rank_block < 1:
            raise ValueError(
                f"block_rows {block_rows} leaves no room for one rank column "
                f"in {smem_limit} bytes of shared memory")
    return ModePlan(
        mode=mode,
        num_rows=int(num_rows),
        block_rows=block_rows,
        tile=tile,
        rank_block=int(min(rank_block, rank)),
        num_row_blocks=max(1, -(-int(num_rows) // block_rows)),
        slab_cap=slab_cap(num_rows, nnz_cap, block_rows, tile),
        nnz_cap=int(nnz_cap),
    )


@functools.lru_cache(maxsize=None)
def plan_bucket(shape: tuple[int, ...], nnz_cap: int, rank: int,
                kappa: int = 1, *, block_rows: int | None = None,
                tile: int | None = None, rank_block: int | None = None,
                smem_limit: int = DEFAULT_SMEM_BYTES) -> PartitionPlan:
    """Static plan for a (shape, nnz_cap) bucket class -- no tensor data.
    ``smem_limit`` is the shared memory one block may use on the target
    device (``kernels.mttkrp_slab.shared_memory_per_block``)."""
    shape = tuple(int(s) for s in shape)
    modes = tuple(
        _mode_plan(shape[d], d, rank, nnz_cap, block_rows=block_rows,
                   tile=tile, rank_block=rank_block, smem_limit=smem_limit,
                   num_inputs=max(1, len(shape) - 1))
        for d in range(len(shape)))
    return PartitionPlan(shape=shape, nnz_cap=int(nnz_cap), rank=int(rank),
                         kappa=int(kappa), modes=modes)


def plan_layout(layout, rank: int, *, nnz_cap: int | None = None,
                block_rows: int | None = None, tile: int | None = None,
                rank_block: int | None = None,
                smem_limit: int = DEFAULT_SMEM_BYTES) -> ModePlan:
    """Plan one mode from a real layout; ``nnz_cap`` defaults to the
    layout's own nnz (no slab padding beyond the packing minimum)."""
    cap = layout.nnz if nnz_cap is None else int(nnz_cap)
    return _mode_plan(layout.num_rows, layout.mode, rank, cap,
                      block_rows=block_rows, tile=tile,
                      rank_block=rank_block, smem_limit=smem_limit,
                      num_inputs=len(layout.input_modes()))


def plan_tensor(tensor, rank: int, kappa: int = 1, *,
                nnz_cap: int | None = None, **tiling) -> PartitionPlan:
    """Per-tensor plan (bucket of one): quantizes nnz through the same
    ``quantize_nnz`` rule so a lone tensor and its bucket class agree.
    ``tiling`` pins ``block_rows``/``tile``/``rank_block``/``smem_limit``."""
    cap = quantize_nnz(tensor.nnz) if nnz_cap is None else int(nnz_cap)
    return plan_bucket(tuple(int(s) for s in tensor.shape), cap, rank, kappa,
                       **tiling)
