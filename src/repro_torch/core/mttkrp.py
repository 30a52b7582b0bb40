"""spMTTKRP engines over mode-specific layouts (port of ``repro.core.mttkrp``).

Backends:
  'slab'    -- the hand-written Hopper kernel on the packed slabs
               (``kernels.mttkrp_slab``); the counterpart of 'pallas'.
  'segment' -- plain torch: gather-Hadamard-``index_add_`` on the sorted
               layout.
  'coo'     -- unsorted elementwise formulation (materializes the (nnz, R)
               intermediate the paper eliminates).

All backends return the output factor in ORIGINAL row order, float32.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels.mttkrp_slab import mttkrp_slab, shared_memory_per_block, slab_chunks
from . import plan as plan_mod
from .coo import SparseTensor
from .layout import ModeLayout, build_all_mode_layouts
from .load_balance import Scheme


@dataclasses.dataclass
class MTTKRPPlan:
    """Preprocessing product: all mode copies + (lazily) packed slabs and
    their device copies, built once and reused by every ALS iteration.
    With a ``partition`` attached, packing follows its static per-mode
    decisions (slab caps included)."""

    tensor: SparseTensor
    kappa: int
    layouts: list[ModeLayout]
    device: torch.device
    assignment: str = "greedy"
    block_rows: int = kops.DEFAULT_BLOCK_ROWS
    tile: int = kops.DEFAULT_TILE
    partition: plan_mod.PartitionPlan | None = None
    _packed: dict[int, kops.PackedModeLayout] = dataclasses.field(default_factory=dict)
    _dev_arrays: dict[int, tuple] = dataclasses.field(default_factory=dict)
    _dev_packed: dict[int, tuple] = dataclasses.field(default_factory=dict)
    _dev_structural: dict[tuple, tuple] = dataclasses.field(default_factory=dict)
    _dev_coo: tuple | None = None

    def packed(self, mode: int) -> kops.PackedModeLayout:
        if mode not in self._packed:
            if self.partition is not None:
                mp = self.partition.modes[mode]
                self._packed[mode] = kops.pack_layout(
                    self.layouts[mode], block_rows=mp.block_rows,
                    tile=mp.tile, num_slabs_cap=mp.slab_cap)
            else:
                self._packed[mode] = kops.pack_layout(
                    self.layouts[mode], block_rows=self.block_rows,
                    tile=self.tile)
        return self._packed[mode]

    def mode_plan(self, mode: int, rank: int) -> plan_mod.ModePlan:
        """The static per-mode plan this tensor executes under: the
        attached partition plan when present, else a per-layout plan
        pinned to the packing's tiling, with ``rank_block`` sized from the
        device's shared memory."""
        if self.partition is not None and self.partition.rank == rank:
            return self.partition.modes[mode]
        p = self.packed(mode)
        return plan_mod.plan_layout(
            self.layouts[mode], rank, block_rows=p.block_rows, tile=p.tile,
            smem_limit=shared_memory_per_block(self.device))

    def device_arrays(self, mode: int) -> tuple:
        """Layout arrays on the plan's device (cached):
        ``(idx, rows, vals, row_perm)``."""
        if mode not in self._dev_arrays:
            lay = self.layouts[mode]
            in_modes = lay.input_modes()
            dev = self.device
            self._dev_arrays[mode] = (
                torch.as_tensor(np.ascontiguousarray(lay.indices[:, in_modes]), device=dev),
                torch.as_tensor(lay.rows, device=dev),
                torch.as_tensor(lay.values.astype(np.float32), device=dev),
                torch.as_tensor(lay.row_perm.astype(np.int64), device=dev),
            )
        return self._dev_arrays[mode]

    def device_packed(self, mode: int) -> tuple:
        """Packed slab arrays on the plan's device (cached, uploaded once):
        ``(idx_packed, vals_packed, lrows_packed, rb_of, chunks, row_perm)``."""
        if mode not in self._dev_packed:
            p = self.packed(mode)
            dev = self.device
            self._dev_packed[mode] = (
                torch.as_tensor(p.idx_packed, device=dev),
                torch.as_tensor(p.weighted_vals(), device=dev),
                torch.as_tensor(p.lrows_packed, device=dev),
                torch.as_tensor(p.rb_of, device=dev),
                slab_chunks(p.rb_of, p.num_row_blocks, dev),
                torch.as_tensor(self.layouts[mode].row_perm.astype(np.int64),
                                device=dev),
            )
        return self._dev_packed[mode]

    def device_structural(self, mode: int, backend: str) -> tuple:
        """The valued MTTKRP's structural arrays on the plan's device
        (cached; no values): for ``slab`` ``(idx_packed, lrows_packed,
        rb_of, chunks, row_perm, perm, val_scatter)``, for ``segment``
        ``(idx, rows, row_perm, perm)``.  ``perm`` maps canonical to layout
        order and ``val_scatter`` layout order to packed slots (int64)."""
        key = (mode, backend)
        if key not in self._dev_structural:
            perm = torch.as_tensor(self.layouts[mode].perm.astype(np.int64),
                                   device=self.device)
            if backend == "slab":
                idxp, _, lrowsp, rb_of, chunks, row_perm = self.device_packed(mode)
                scatter = torch.as_tensor(
                    self.packed(mode).val_scatter.astype(np.int64),
                    device=self.device)
                arrays = (idxp, lrowsp, rb_of, chunks, row_perm, perm, scatter)
            elif backend == "segment":
                idx, rows, _, row_perm = self.device_arrays(mode)
                arrays = (idx, rows, row_perm, perm)
            else:
                raise ValueError(f"no structural mode data for backend {backend!r}")
            self._dev_structural[key] = arrays
        return self._dev_structural[key]

    def device_coo(self) -> tuple:
        """COO indices/values on the plan's device (cached)."""
        if self._dev_coo is None:
            self._dev_coo = (
                torch.as_tensor(self.tensor.indices, device=self.device),
                torch.as_tensor(self.tensor.values.astype(np.float32),
                                device=self.device),
            )
        return self._dev_coo


def make_plan(
    tensor: SparseTensor,
    kappa: int,
    *,
    scheme: Scheme | None = None,
    assignment: str = "greedy",
    policy: str = "threshold",
    block_rows: int = kops.DEFAULT_BLOCK_ROWS,
    tile: int = kops.DEFAULT_TILE,
    partition: plan_mod.PartitionPlan | None = None,
    device="cuda",
) -> MTTKRPPlan:
    """All mode copies of ``tensor`` over ``kappa`` partitions, with each
    mode's scheme forced (``scheme``) or chosen by ``policy``
    ('threshold', the paper's rule, or 'cost', ``scheme_cost``'s argmin).
    The packings and device arrays are cached on the returned plan only,
    so plans whose modes chose different schemes never share them."""
    layouts = build_all_mode_layouts(tensor, kappa, scheme=scheme,
                                     assignment=assignment, policy=policy)
    return MTTKRPPlan(
        tensor=tensor,
        kappa=kappa,
        layouts=layouts,
        device=resolve_device(device),
        assignment=assignment,
        block_rows=block_rows,
        tile=tile,
        partition=partition,
    )


def unrelabel_rows(out_rel: torch.Tensor, row_perm: torch.Tensor) -> torch.Tensor:
    """relabeled -> original rows: ``out[row_perm[i]] = out_rel[i]``.
    ``row_perm`` is a permutation, so every row is written; rows with no
    nonzeros carry the zeros the backend produced."""
    return torch.zeros_like(out_rel).index_copy_(0, row_perm, out_rel)


def slab_backend(mode_data, factors: Sequence[torch.Tensor], num_rows: int,
                 slab_meta: tuple[int, int, int, int]) -> torch.Tensor:
    """The slab kernel on one mode's device data
    ``(idx_packed, vals_packed, lrows_packed, rb_of, chunks, row_perm)``:
    ``(num_rows, R)`` in original row order."""
    idxp, valsp, lrowsp, rb_of, chunks, row_perm = mode_data
    nrb, br, tile, rblk = slab_meta
    out = mttkrp_slab(idxp, valsp, lrowsp, rb_of, list(factors),
                      chunks=chunks, num_row_blocks=nrb, block_rows=br,
                      tile=tile, rank_block=rblk)[:num_rows]
    return unrelabel_rows(out, row_perm)


def mttkrp(
    plan: MTTKRPPlan,
    factors: Sequence[torch.Tensor],
    mode: int,
    *,
    backend: str = "slab",
) -> torch.Tensor:
    """MTTKRP along ``mode``: returns (I_mode, R) float32 in original row
    order.  ``factors`` lie on the plan's device."""
    lay = plan.layouts[mode]
    in_factors = [factors[w] for w in lay.input_modes()]

    if backend == "segment":
        idx, rows, vals, row_perm = plan.device_arrays(mode)
        out_rel = kref.mttkrp_sorted_segments(idx, rows, vals, in_factors,
                                              lay.num_rows)
        return unrelabel_rows(out_rel, row_perm)
    if backend == "slab":
        packed = plan.packed(mode)
        rank_block = plan.mode_plan(mode, int(in_factors[0].shape[1])).rank_block
        meta = (packed.num_row_blocks, packed.block_rows, packed.tile, rank_block)
        return slab_backend(plan.device_packed(mode),
                            in_factors, lay.num_rows, meta)
    if backend == "coo":
        indices, values = plan.device_coo()
        return kref.mttkrp_coo(indices, values, list(factors), mode,
                               lay.num_rows)
    raise ValueError(f"unknown backend {backend!r}")


def mttkrp_dense_ref(tensor: SparseTensor, factors: Sequence[np.ndarray],
                     mode: int) -> np.ndarray:
    return kref.mttkrp_dense(tensor, list(factors), mode)
