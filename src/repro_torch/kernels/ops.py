"""Host-side slab packing and the packed-layout MTTKRP wrappers.

``pack_slabs`` converts a row-sorted mode layout into the fixed-shape slab
arrays the kernel consumes.  Packing is one-time host preprocessing per
mode copy (amortized over all ALS iterations).  The packed arrays are
bitwise those of ``repro.kernels.ops`` at the same ``(block_rows, tile)``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .mttkrp_slab import (max_rank_block, mttkrp_slab, mttkrp_slab_plain,
                          shared_memory_per_block, slab_chunks)

DEFAULT_TILE = 256
DEFAULT_BLOCK_ROWS = 128


@dataclasses.dataclass(frozen=True)
class PackedModeLayout:
    """Device-ready slab packing of one mode layout.

    Shapes: G slabs, T = tile nonzeros per slab, W input modes.
    """

    mode: int
    num_rows: int              # relabeled rows covered (<= num_row_blocks*BR)
    num_row_blocks: int
    block_rows: int
    tile: int
    rb_of: np.ndarray          # (G,) int32
    first: np.ndarray          # (G,) int32
    idx_packed: np.ndarray     # (W, G*T) int32
    vals_packed: np.ndarray    # (1, G*T) float32
    lrows_packed: np.ndarray   # (1, G*T) int32
    input_modes: tuple[int, ...]
    pad_fraction: float        # padding overhead (diagnostic)
    num_real_slabs: int = -1   # slabs before cap padding
    # (nnz,) int32 flat position in vals_packed[0] of each layout-order
    # entry: scattering a fresh value vector through it rebuilds
    # vals_packed on device without repacking.
    val_scatter: np.ndarray | None = None
    # (1, G*T) float32 per-entry observation weights (None: unweighted);
    # padding slots carry weight 0.
    wts_packed: np.ndarray | None = None

    @property
    def num_slabs(self) -> int:
        return int(self.rb_of.shape[0])

    def weighted_vals(self) -> np.ndarray:
        """Kernel-ready values: ``vals_packed * wts_packed`` (or
        ``vals_packed`` unchanged for an unweighted packing)."""
        if self.wts_packed is None:
            return self.vals_packed
        return (self.vals_packed * self.wts_packed).astype(np.float32)


def pack_slabs(
    input_indices: np.ndarray,   # (nnz, W) int32 — input-mode columns only
    rows: np.ndarray,            # (nnz,) int32 — relabeled rows, sorted
    values: np.ndarray,          # (nnz,)
    num_rows: int,
    *,
    mode: int = 0,
    input_modes: Sequence[int] = (),
    block_rows: int = DEFAULT_BLOCK_ROWS,
    tile: int = DEFAULT_TILE,
    num_slabs_cap: int | None = None,
    weights: np.ndarray | None = None,
) -> PackedModeLayout:
    """Pack row-sorted COO data into per-row-block slabs of ``tile`` nonzeros.

    Every row block gets >= 1 slab (an empty block gets one all-padding
    slab so its output block is zero).  Padding entries carry value 0 and
    indices 0, contributing nothing.

    ``num_slabs_cap`` (from ``core.plan.slab_cap``) pads the grid with
    appended all-zero slabs on the LAST row block, making the array shapes
    a function of the plan rather than the data.  The real slabs are
    untouched and each extra slab contributes ``+= 0.0``.
    ``weights`` -- optional per-entry weights aligned with ``values``,
    packed into ``wts_packed`` through the same slab placement.
    """
    nnz = len(values)
    if nnz and not bool(np.all(rows[:-1] <= rows[1:])):
        raise ValueError("rows must be sorted (build via core.layout)")
    W = input_indices.shape[1]
    nb = max(1, -(-num_rows // block_rows))
    row_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=num_rows), out=row_ptr[1:])
    starts = row_ptr[np.minimum(np.arange(nb) * block_rows, num_rows)]
    ends = row_ptr[np.minimum((np.arange(nb) + 1) * block_rows, num_rows)]
    lens = ends - starts
    slabs_per_block = np.maximum(1, -(-lens // tile))
    G = int(slabs_per_block.sum())

    slab_block = np.repeat(np.arange(nb, dtype=np.int64), slabs_per_block)
    # Rank of each slab within its block.
    block_start_slab = np.zeros(nb, dtype=np.int64)
    np.cumsum(slabs_per_block[:-1], out=block_start_slab[1:])
    rank = np.arange(G, dtype=np.int64) - block_start_slab[slab_block]

    src_start = starts[slab_block] + rank * tile
    length = np.clip(ends[slab_block] - src_start, 0, tile)
    src = src_start[:, None] + np.arange(tile, dtype=np.int64)[None, :]
    valid = np.arange(tile)[None, :] < length[:, None]
    src_c = np.minimum(src, max(nnz - 1, 0))

    if weights is not None and len(weights) != nnz:
        raise ValueError(
            f"weights length {len(weights)} != nnz {nnz}")
    wts_p = None
    if nnz:
        vals_p = np.where(valid, values[src_c], 0).astype(np.float32)
        if weights is not None:
            wts_p = np.where(valid, weights[src_c], 0).astype(np.float32)
        idx_p = np.where(valid[:, :, None], input_indices[src_c], 0).astype(np.int32)
        lrow_p = np.where(
            valid, rows[src_c] - slab_block[:, None] * block_rows, 0
        ).astype(np.int32)
        # Invert the (layout entry -> packed slot) placement.
        flat = (np.arange(G, dtype=np.int64)[:, None] * tile
                + np.arange(tile, dtype=np.int64)[None, :])
        val_scatter = np.empty(nnz, dtype=np.int32)
        val_scatter[src[valid]] = flat[valid].astype(np.int32)
    else:
        vals_p = np.zeros((G, tile), np.float32)
        if weights is not None:
            wts_p = np.zeros((G, tile), np.float32)
        idx_p = np.zeros((G, tile, W), np.int32)
        lrow_p = np.zeros((G, tile), np.int32)
        val_scatter = np.zeros(0, dtype=np.int32)

    G_real = G
    if num_slabs_cap is not None:
        if G > num_slabs_cap:
            raise ValueError(
                f"packing needs {G} slabs but the plan caps at "
                f"{num_slabs_cap}; nnz exceeds the plan's nnz_cap")
        extra = num_slabs_cap - G
        if extra:
            # Appended zero slabs revisit the last row block: first=0,
            # values 0, local row 0 — an exact += 0.0.
            slab_block = np.concatenate(
                [slab_block, np.full(extra, nb - 1, dtype=np.int64)])
            rank = np.concatenate(
                [rank, np.ones(extra, dtype=np.int64)])   # never first
            vals_p = np.concatenate(
                [vals_p, np.zeros((extra, tile), np.float32)])
            if wts_p is not None:
                wts_p = np.concatenate(
                    [wts_p, np.zeros((extra, tile), np.float32)])
            idx_p = np.concatenate(
                [idx_p, np.zeros((extra, tile, W), np.int32)])
            lrow_p = np.concatenate(
                [lrow_p, np.zeros((extra, tile), np.int32)])
            G = num_slabs_cap

    pad = 1.0 - (nnz / float(G * tile)) if G else 0.0
    return PackedModeLayout(
        mode=mode,
        num_rows=num_rows,
        num_row_blocks=nb,
        block_rows=block_rows,
        tile=tile,
        rb_of=slab_block.astype(np.int32),
        first=(rank == 0).astype(np.int32),
        idx_packed=np.ascontiguousarray(
            idx_p.reshape(G * tile, W).T.astype(np.int32)
        ),
        vals_packed=vals_p.reshape(1, G * tile),
        lrows_packed=lrow_p.reshape(1, G * tile).astype(np.int32),
        input_modes=tuple(input_modes) or tuple(range(W)),
        pad_fraction=float(pad),
        num_real_slabs=G_real,
        val_scatter=val_scatter,
        wts_packed=(None if wts_p is None
                    else wts_p.reshape(1, G * tile).astype(np.float32)),
    )


def pack_layout(layout, *, block_rows: int = DEFAULT_BLOCK_ROWS,
                tile: int = DEFAULT_TILE,
                num_slabs_cap: int | None = None,
                weights: np.ndarray | None = None) -> PackedModeLayout:
    """Pack a ``core.layout.ModeLayout`` for kernel execution.
    ``weights`` are per-entry weights in CANONICAL COO order; the layout's
    permutation maps them to the packed slots alongside the values."""
    in_modes = layout.input_modes()
    return pack_slabs(
        layout.indices[:, in_modes],
        layout.rows,
        layout.values,
        layout.num_rows,
        mode=layout.mode,
        input_modes=in_modes,
        block_rows=block_rows,
        tile=tile,
        num_slabs_cap=num_slabs_cap,
        weights=(None if weights is None
                 else np.asarray(weights, np.float32)[layout.perm]),
    )


def _packed_tensors(packed: PackedModeLayout, device) -> tuple:
    return (torch.as_tensor(packed.idx_packed, device=device),
            torch.as_tensor(packed.weighted_vals(), device=device),
            torch.as_tensor(packed.lrows_packed, device=device),
            torch.as_tensor(packed.rb_of, device=device))


def mttkrp_packed(
    packed: PackedModeLayout,
    factors: Sequence[torch.Tensor],
    *,
    rank_block: int | None = None,
) -> torch.Tensor:
    """Run the slab kernel on a packed layout (on the factors' device).
    ``factors`` are the input factor matrices in ``packed.input_modes``
    order.  Returns the relabeled ``(num_rows, R)`` float32 output.

    A weighted packing runs the WEIGHTED MTTKRP: the kernel takes
    ``weighted_vals()``.  ``rank_block=None`` keeps the widest rank block
    that fits the block's shared memory."""
    device = factors[0].device
    if rank_block is None:
        rank_block = max_rank_block(
            packed.block_rows, shared_memory_per_block(device), len(factors))
    idx, vals, lrows, rb_of = _packed_tensors(packed, device)
    out = mttkrp_slab(
        idx, vals, lrows, rb_of, list(factors),
        chunks=slab_chunks(packed.rb_of, packed.num_row_blocks, device),
        num_row_blocks=packed.num_row_blocks,
        block_rows=packed.block_rows,
        tile=packed.tile,
        rank_block=rank_block,
    )
    return out[: packed.num_rows]


def mttkrp_packed_ref(
    packed: PackedModeLayout, factors: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Oracle evaluated on the *packed* arrays (padding included): the
    kernel's plain version on the data the kernel sees (weighted values
    for a weighted packing)."""
    out = mttkrp_slab_plain(
        *_packed_tensors(packed, factors[0].device), list(factors),
        num_row_blocks=packed.num_row_blocks, block_rows=packed.block_rows,
        tile=packed.tile)
    return out[: packed.num_rows]
