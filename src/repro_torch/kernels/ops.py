"""Slab packing and the packed-layout MTTKRP wrappers.

``pack_slabs`` converts a row-sorted mode layout into the fixed-shape slab
arrays the kernel consumes.  Packing is one-time preprocessing per mode
copy (amortized over all ALS iterations).  The per-slab arrays (``rb_of``,
``first``) come from per-row-block arithmetic on the host; the per-slot
arrays are torch gathers on the device the layout's data lies on, and
stay there.  Their host copies are made on first read.  The packed arrays
are bitwise those of ``repro.kernels.ops`` at the same ``(block_rows,
tile)``.

The tile model (``tile_candidates``, ``auto_rank_block``,
``estimate_pack_cost``, ``auto_tiles``) prices a ``(block_rows, tile)``
choice for the Hopper slab kernel, not for the reference's TPU: shared
memory decides feasibility and the cost is in seconds.  ``core.plan``
does not consume it (see there); ``obs.calibrate`` fits its constants.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .mttkrp_slab import (CHUNK_SLABS, DEFAULT_SMEM_BYTES, GROUP_CHUNKS,
                          max_rank_block, mttkrp_slab, mttkrp_slab_plain,
                          shared_memory_per_block, slab_chunks, smem_bytes)

DEFAULT_TILE = 256
DEFAULT_BLOCK_ROWS = 128
# The tile model's default memory rate: the H100 SXM's HBM3 rate from its
# datasheet, not a measurement.  ``obs.calibrate.fit_pack_cost`` fits the
# rate and the per-chunk time on the card in use.
DATASHEET_BYTES_PER_S = 3.35e12


def _slot_view(name: str) -> property:
    """The host copy of the packing's ``slots[name]`` (None where absent),
    made on first read."""
    return property(lambda self: self._host_copy(
        name, lambda: self.slots.get(name)))


@dataclasses.dataclass(eq=False)
class PackedModeLayout:
    """Device-ready slab packing of one mode layout.

    Shapes: G slabs, T = tile nonzeros per slab, W input modes.  The
    per-slot arrays live as tensors in ``slots`` on the device that packed
    them; the attributes of the same names are their host copies, made on
    first read (a view on the CPU).
    """

    mode: int
    num_rows: int              # relabeled rows covered (<= num_row_blocks*BR)
    num_row_blocks: int
    block_rows: int
    tile: int
    rb_of: np.ndarray          # (G,) int32
    first: np.ndarray          # (G,) int32
    input_modes: tuple[int, ...]
    pad_fraction: float        # padding overhead (diagnostic)
    num_real_slabs: int        # slabs before cap padding
    # idx_packed (W, G*T) int32, vals_packed (1, G*T) float32,
    # lrows_packed (1, G*T) int32, rb_of (G,) int32 and, for a weighted
    # packing, wts_packed (1, G*T) float32 (padding slots weight 0).
    slots: dict
    # Per row block: its first layout entry and the packed slot of that
    # entry (``val_scatter`` in closed form).
    block_entry: np.ndarray
    block_slot: np.ndarray
    nnz: int
    _host: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_slabs(self) -> int:
        return int(self.rb_of.shape[0])

    @property
    def device(self) -> torch.device:
        return self.slots["idx_packed"].device

    def _host_copy(self, name: str, make) -> np.ndarray | None:
        """Host copy of the tensor ``make()`` gives, made on first read."""
        if name not in self._host:
            t = make()
            self._host[name] = None if t is None else t.cpu().numpy()
        return self._host[name]

    idx_packed = _slot_view("idx_packed")
    vals_packed = _slot_view("vals_packed")
    lrows_packed = _slot_view("lrows_packed")
    wts_packed = _slot_view("wts_packed")

    @property
    def val_scatter(self) -> np.ndarray:
        """(nnz,) int32 flat position in vals_packed[0] of each
        layout-order entry: scattering a fresh value vector through it
        rebuilds vals_packed on device without repacking."""
        return self._host_copy("val_scatter", self.scatter_tensor)

    def scatter_tensor(self) -> torch.Tensor:
        """``val_scatter`` on the packing's device (made anew each call):
        an entry's slot is its row block's first slot plus its offset
        from the block's first entry."""
        dev = self.device
        lens = np.diff(self.block_entry)
        shift = torch.as_tensor(self.block_slot[:-1] - self.block_entry[:-1],
                                device=dev)
        pos = torch.arange(self.nnz, dtype=torch.int64, device=dev)
        pos += torch.repeat_interleave(
            shift, torch.as_tensor(lens, device=dev), output_size=self.nnz)
        return pos.to(torch.int32)

    def weighted_vals_tensor(self) -> torch.Tensor:
        """Kernel-ready values on the packing's device: ``vals_packed *
        wts_packed`` (``vals_packed`` itself for an unweighted packing)."""
        vals, wts = self.slots["vals_packed"], self.slots.get("wts_packed")
        return vals if wts is None else vals * wts

    def weighted_vals(self) -> np.ndarray:
        """Host copy of ``weighted_vals_tensor()``."""
        if self.slots.get("wts_packed") is None:
            return self.vals_packed
        return self._host_copy("weighted", self.weighted_vals_tensor)


def _slab_grid(row_ptr: np.ndarray, num_rows: int, block_rows: int,
               tile: int):
    """Per-slab host arrays of a row-sorted layout with CSR ``row_ptr``:
    ``(nb, block row of each slab, rank within its block, first source
    entry, valid length, each block's first entry and first slab)``.
    Every row block gets >= 1 slab."""
    nb = max(1, -(-num_rows // block_rows))
    bounds = row_ptr[np.minimum(np.arange(nb + 1) * block_rows, num_rows)]
    starts, ends = bounds[:-1], bounds[1:]
    slabs_per_block = np.maximum(1, -(-(ends - starts) // tile))
    G = int(slabs_per_block.sum())
    slab_block = np.repeat(np.arange(nb, dtype=np.int64), slabs_per_block)
    # Rank of each slab within its block.
    block_start_slab = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(slabs_per_block, out=block_start_slab[1:])
    rank = np.arange(G, dtype=np.int64) - block_start_slab[slab_block]
    src_start = starts[slab_block] + rank * tile
    length = np.clip(ends[slab_block] - src_start, 0, tile)
    return (nb, slab_block, rank, src_start, length, bounds,
            block_start_slab * tile)


def _pack(columns: Sequence[torch.Tensor], values: torch.Tensor,
          weights: torch.Tensor | None, order: torch.Tensor | None,
          row_ptr: np.ndarray, *, nnz: int,
          num_rows: int, mode: int, input_modes: Sequence[int],
          block_rows: int, tile: int,
          num_slabs_cap: int | None) -> PackedModeLayout:
    """The packing, on the device of ``values``.

    ``columns`` (W index columns), ``values`` and ``weights`` are in
    source order; ``order`` maps execution order to source order (None:
    the same order; uploaded for the packing if it lies elsewhere);
    ``row_ptr`` holds the relabeled rows' CSR offsets in execution order.  Each array is written in place, so besides the
    result at most two slot-sized index arrays and a slot mask are live.
    """
    dev = values.device
    W = len(columns)
    nb, slab_block, rank, src_start, length, bounds, slot0 = _slab_grid(
        row_ptr, num_rows, block_rows, tile)
    G_real = len(slab_block)
    G = G_real
    if num_slabs_cap is not None:
        if G_real > num_slabs_cap:
            raise ValueError(
                f"packing needs {G_real} slabs but the plan caps at "
                f"{num_slabs_cap}; nnz exceeds the plan's nnz_cap")
        # Appended zero slabs revisit the last row block: first=0,
        # values 0, local row 0 — an exact += 0.0.
        G = num_slabs_cap
    rb_of = np.full(G, nb - 1, dtype=np.int32)
    rb_of[:G_real] = slab_block
    first = np.zeros(G, dtype=np.int32)
    first[:G_real] = rank == 0
    real, total = G_real * tile, G * tile

    # Every real slot is written below (padding by the masked fills);
    # the appended cap slabs are zeroed here.
    alloc = torch.empty if nnz else torch.zeros
    slots = {"idx_packed": alloc((W, total), dtype=torch.int32, device=dev),
             "vals_packed": alloc((1, total), dtype=torch.float32, device=dev),
             "lrows_packed": alloc((1, total), dtype=torch.int32, device=dev)}
    if weights is not None:
        slots["wts_packed"] = alloc((1, total), dtype=torch.float32,
                                    device=dev)
    for t in slots.values():
        t[:, real:].zero_()
    if nnz:
        itype = torch.int32 if nnz + tile < 2 ** 31 else torch.int64
        lane = torch.arange(tile, dtype=itype, device=dev)
        src = (torch.as_tensor(src_start, dtype=itype, device=dev)[:, None]
               + lane[None, :]).reshape(-1).clamp_(max=nnz - 1)
        pad = (lane[None, :] >= torch.as_tensor(
            length, dtype=itype, device=dev)[:, None]).reshape(-1)
        # An entry's relabeled row: the rows that end at or before it.
        ends = torch.as_tensor(row_ptr[1:], dtype=itype, device=dev)
        lrows = slots["lrows_packed"][0, :real]
        if itype == torch.int32:
            torch.searchsorted(ends, src, right=True, out_int32=True,
                               out=lrows)
        else:
            lrows.copy_(torch.searchsorted(ends, src, right=True))
        lrows.view(G_real, tile).sub_(torch.as_tensor(
            slab_block * block_rows, dtype=torch.int32, device=dev)[:, None])
        lrows.masked_fill_(pad, 0)
        if order is not None:
            src = torch.index_select(order.to(dev), 0, src)
        gathers = [(slots["idx_packed"][j], col.to(torch.int32))
                   for j, col in enumerate(columns)]
        gathers += [(slots[name][0], arr) for name, arr in
                    (("vals_packed", values), ("wts_packed", weights))
                    if arr is not None]
        for dst, arr in gathers:
            out = dst[:real]
            if arr.dtype == out.dtype:
                torch.index_select(arr, 0, src, out=out)
            else:
                out.copy_(torch.index_select(arr, 0, src))
            out.masked_fill_(pad, 0)
        del src, pad
    slots["rb_of"] = torch.as_tensor(rb_of, device=dev)

    return PackedModeLayout(
        mode=mode,
        num_rows=num_rows,
        num_row_blocks=nb,
        block_rows=block_rows,
        tile=tile,
        rb_of=rb_of,
        first=first,
        input_modes=tuple(input_modes) or tuple(range(W)),
        pad_fraction=float(1.0 - (nnz / float(total)) if G else 0.0),
        num_real_slabs=G_real,
        slots=slots,
        block_entry=bounds,
        block_slot=slot0,
        nnz=nnz,
    )


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def pack_slabs(
    input_indices,               # (nnz, W) int32 — input-mode columns only
    rows,                        # (nnz,) int32 — relabeled rows, sorted
    values,                      # (nnz,)
    num_rows: int,
    *,
    mode: int = 0,
    input_modes: Sequence[int] = (),
    block_rows: int = DEFAULT_BLOCK_ROWS,
    tile: int = DEFAULT_TILE,
    num_slabs_cap: int | None = None,
    weights=None,
) -> PackedModeLayout:
    """Pack row-sorted COO data into per-row-block slabs of ``tile`` nonzeros.

    Arrays may be numpy (packed on the CPU) or tensors (packed on their
    device).  Every row block gets >= 1 slab (an empty block gets one
    all-padding slab so its output block is zero).  Padding entries carry
    value 0 and indices 0, contributing nothing.

    ``num_slabs_cap`` (from ``core.plan.slab_cap``) pads the grid with
    appended all-zero slabs on the LAST row block, making the array shapes
    a function of the plan rather than the data.  The real slabs are
    untouched and each extra slab contributes ``+= 0.0``.
    ``weights`` -- optional per-entry weights aligned with ``values``,
    packed into ``wts_packed`` through the same slab placement.
    """
    idx, rows, values = (_as_tensor(a) for a in (input_indices, rows, values))
    nnz = int(values.shape[0])
    if nnz and not bool((rows[:-1] <= rows[1:]).all()):
        raise ValueError("rows must be sorted (build via core.layout)")
    if weights is not None and len(weights) != nnz:
        raise ValueError(
            f"weights length {len(weights)} != nnz {nnz}")
    row_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(torch.bincount(rows, minlength=num_rows).cpu().numpy(),
              out=row_ptr[1:])
    return _pack([idx[:, j] for j in range(idx.shape[1])], values,
                  None if weights is None else _as_tensor(weights),
                  None, row_ptr, nnz=nnz,
                  num_rows=num_rows, mode=mode, input_modes=input_modes,
                  block_rows=block_rows, tile=tile,
                  num_slabs_cap=num_slabs_cap)


def pack_layout(layout, *, block_rows: int = DEFAULT_BLOCK_ROWS,
                tile: int = DEFAULT_TILE,
                num_slabs_cap: int | None = None,
                weights: np.ndarray | None = None,
                source: tuple | None = None) -> PackedModeLayout:
    """Pack a ``core.layout.ModeLayout`` for kernel execution, gathering
    each slot straight from the canonical COO through ``layout.order``.
    ``weights`` are per-entry weights in CANONICAL COO order; the layout's
    permutation maps them to the packed slots alongside the values.
    ``source`` -- ``(columns (N, nnz) int32, values (nnz,) float32)``, the
    canonical COO on the device to pack on (default: the host tensor's
    arrays, packed on the CPU).  A layout with host arrays only (as
    ``repro.core.layout`` builds) is packed from them on the CPU."""
    in_modes = layout.input_modes()
    if not hasattr(layout, "order"):
        return pack_slabs(
            layout.indices[:, in_modes], layout.rows, layout.values,
            layout.num_rows, mode=layout.mode, input_modes=in_modes,
            block_rows=block_rows, tile=tile, num_slabs_cap=num_slabs_cap,
            weights=(None if weights is None
                     else np.asarray(weights, np.float32)[layout.perm]))
    if source is None:
        from ..core.layout import coo_columns
        source = (coo_columns(layout.tensor, "cpu"),
                  torch.from_numpy(layout.tensor.values))
    columns, values = source
    dev = values.device
    if weights is not None:
        weights = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
    return _pack([columns[w] for w in in_modes], values, weights,
                 layout.order, layout.row_ptr, nnz=layout.nnz,
                 num_rows=layout.num_rows, mode=layout.mode,
                 input_modes=in_modes, block_rows=block_rows, tile=tile,
                 num_slabs_cap=num_slabs_cap)


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
            packed.block_rows, shared_memory_per_block(device), len(factors),
            widest=int(factors[0].shape[-1]))
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


# -- the tile model: (block_rows, tile) priced for the slab kernel on Hopper --
#
# The reference prices a TPU here (VMEM budget, MXU width, grid-step
# overhead); none of that carries over.  The slab kernel's limits are its
# shared memory per pass-one block and its thread count
# (``mttkrp_slab.max_rank_block``), and its time is the bytes it moves
# (inputs, output and the partial tiles between its passes) plus a fixed
# cost per chunk of ``CHUNK_SLABS`` slabs.  ``estimate_pack_cost``
# and ``auto_tiles`` read only ``num_rows`` / ``nnz`` / ``nmodes`` /
# ``shape`` / ``row_ptr`` of a layout, so no packing is built.


def tile_candidates():
    """The ``(block_rows, tile)`` pairs the model prices: the reference's
    grid.  The wrapper and ``csrc/mttkrp_slab.cu`` take any ``tile >= 1``
    (a multiple of 4 streams slots in 16-byte granules, as all of these
    do) and any ``block_rows`` whose pass-one block fits shared memory
    with one rank column; ``estimate_pack_cost`` judges that per mode."""
    return [(br, t) for br in (8, 32, 128, 256) for t in (64, 128, 256, 512)]


def auto_rank_block(rank: int, block_rows: int, tile: int, factor_rows: int,
                    num_inputs: int, *,
                    smem_limit: int = DEFAULT_SMEM_BYTES) -> int:
    """Widest rank block of at most ``rank`` columns whose pass-one block
    fits ``smem_limit`` bytes of shared memory and the thread limit at
    ``block_rows``; 0 when not one column fits.  (Not simply ``min(rank,
    max_rank_block)``: shared memory is not monotone in the rank block,
    since four-column blocks have more walkers, so a narrower block can
    overflow where a wider one fits.)  ``tile`` and ``factor_rows`` do
    not enter: the slot ring's stages are sized per walker whatever the
    tile, and factors are staged only where the rest leaves room
    (``launch_config``)."""
    return max_rank_block(int(block_rows), int(smem_limit), int(num_inputs),
                          widest=int(rank))


def estimate_pack_cost(layout, block_rows: int, tile: int, rank: int,
                       factor_rows: int | None = None, *,
                       smem_limit: int = DEFAULT_SMEM_BYTES,
                       bytes_per_s: float = DATASHEET_BYTES_PER_S,
                       chunk_s: float = 0.0) -> dict:
    """Closed-form slab-kernel time for a ``(block_rows, tile)`` choice,
    without packing.

    grid, pad_fraction -- slabs (every row block at least one, as
                 ``pack_slabs`` packs) and their padding share, counted
                 from ``row_ptr`` as the reference counts them;
    chunks, groups -- pass one's chunks (``CHUNK_SLABS`` slabs of one row
                 block) and pass two's groups (``GROUP_CHUNKS`` chunks);
    bytes      -- the function's inputs and output counted as
                 ``chip_smoke.py::slab_bound`` counts them (the W index
                 streams, local rows and values per slot, the four chunk
                 tables, the factors' columns, the output), with the slot
                 streams read again for every rank block, plus
                 ``partial_bytes``: the ``(block_rows, R)`` partial tiles
                 pass one writes per chunk and pass two reads back, and
                 the group sums between pass two's launches.  The bound
                 leaves the partials out; the kernel pays them, and they
                 are what makes wide row blocks with many chunks slow;
    cost       -- ``bytes / bytes_per_s + chunks * rank blocks * chunk_s``
                 seconds, or inf when not one rank column fits
                 ``smem_limit`` (``smem_ok`` False).
    """
    nb = max(1, -(-layout.num_rows // block_rows))
    row_ptr = layout.row_ptr
    starts = row_ptr[np.minimum(np.arange(nb) * block_rows, layout.num_rows)]
    ends = row_ptr[np.minimum((np.arange(nb) + 1) * block_rows,
                              layout.num_rows)]
    slabs = np.maximum(1, -(-(ends - starts) // tile))
    G = int(slabs.sum())
    slots = G * tile
    pad = 1.0 - layout.nnz / max(slots, 1)
    chunks_rb = -(-slabs // CHUNK_SLABS)
    NC = int(chunks_rb.sum())
    NG = int((-(-chunks_rb // GROUP_CHUNKS)).sum())
    W = layout.nmodes - 1
    if factor_rows is None:
        factor_rows = sum(int(layout.shape[w]) for w in range(layout.nmodes)
                          if w != layout.mode)
    rank_block = auto_rank_block(rank, block_rows, tile, factor_rows, W,
                                 smem_limit=smem_limit)
    num_rank_blocks = -(-int(rank) // rank_block) if rank_block else 0
    table_ints = (NC + 1) + (NG + 1) + 2 * (nb + 1)
    r_pad = max(num_rank_blocks, 1) * max(rank_block, 1)
    partial_bytes = 2 * (NC + NG) * block_rows * r_pad * 4
    nbytes = (max(num_rank_blocks, 1) * slots * (W + 2) * 4 + table_ints * 4
              + int(factor_rows) * int(rank) * 4 + nb * block_rows * int(rank) * 4
              + partial_bytes)
    cost = nbytes / bytes_per_s + NC * num_rank_blocks * chunk_s
    return {"block_rows": block_rows, "tile": tile, "grid": G,
            "pad_fraction": pad, "chunks": NC, "groups": NG,
            "bytes": int(nbytes), "partial_bytes": int(partial_bytes),
            "smem": int(smem_bytes(block_rows, rank_block, num_inputs=W))
            if rank_block else None,
            "rank_block": int(rank_block),
            "num_rank_blocks": int(num_rank_blocks),
            "smem_ok": bool(rank_block >= 1),
            "cost": float(cost) if num_rank_blocks else float("inf")}


def auto_tiles(layout, rank: int = 32, factor_rows: int | None = None, *,
               smem_limit: int = DEFAULT_SMEM_BYTES,
               bytes_per_s: float = DATASHEET_BYTES_PER_S,
               chunk_s: float = 0.0):
    """The feasible ``(block_rows, tile)`` of least modeled time (the
    first in ``tile_candidates`` order on a tie), or the default tiling
    when none is feasible."""
    best = None
    for br, t in tile_candidates():
        c = estimate_pack_cost(layout, br, t, rank, factor_rows,
                               smem_limit=smem_limit,
                               bytes_per_s=bytes_per_s, chunk_s=chunk_s)
        if c["smem_ok"] and (best is None or c["cost"] < best["cost"]):
            best = c
    if best is None:
        return DEFAULT_BLOCK_ROWS, DEFAULT_TILE
    return best["block_rows"], best["tile"]
