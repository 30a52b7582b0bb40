"""Slab-packed segmented spMTTKRP: the Hopper kernel's wrappers and plain versions.

Counterpart of ``repro/kernels/mttkrp_pallas.py`` (the TPU kernel
``_kernel``, launched by ``mttkrp_pallas()`` at its ``pl.pallas_call``).
It computes the same function on the same packed arrays
(``kernels.ops.pack_slabs``)::

    out[rb_of[g] * block_rows + lrow] += val * prod_w F_w[idx_w]

over every packed slot of every slab g, accumulated in float32 whatever
the factors' type (float32 or bfloat16).

The kernel (``csrc/mttkrp_slab.cu``) has three entries, one wrapper each;
each adds one to its ``LAUNCHES`` count per launch:

* ``mttkrp_slab`` -- values baked into the packing (the TPU path's
  ``kernels/ops.py::mttkrp_packed`` and the fused sweep's CP branch);
* ``mttkrp_slab_valued`` -- values supplied at run time (the masked
  method's residuals), scattered into the slab slots through the
  packing's ``val_scatter`` before the launch;
* ``mttkrp_slab_batched`` -- B packings that share one slab cap, tiling
  and rank in one launch (the TPU path's ``jax.vmap`` in the batched
  service).  Lane b is bitwise ``mttkrp_slab`` on lane b's packing.

For CPU tensors each wrapper runs its plain PyTorch version instead
(``mttkrp_slab_plain``, ``mttkrp_slab_batched_plain``: gather, Hadamard,
``index_add_``); that is the only way a wrapper reaches them.  The CPU
tests and ``chip_smoke.py`` hold the kernel against them.

The kernel has no ordered grid, so it runs in two passes: pass one
reduces each *chunk* (a run of at most ``chunk_slabs`` slabs of one row
block) into a partial ``(block_rows, rank_block)`` tile, and pass two adds
the partials of each row block in chunk order.  ``slab_chunks`` builds the
chunk table on the host once per packing, ``stack_chunks`` the padded
table of a batch.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

# Kernel launches made through each wrapper in this process (CPU calls do
# not count).
LAUNCHES = {"mttkrp_slab": 0, "mttkrp_slab_valued": 0, "mttkrp_slab_batched": 0}

THREADS = 256          # target threads per pass-one block
MAX_THREADS = 1024     # hardware limit per block
MAX_INPUTS = 7         # input modes the kernel is instantiated for
CHUNK_SLABS = 32       # slabs per chunk (a fixed size keeps cap padding exact)
# Shared memory a block may use without opting in; the CPU plan sizes
# rank blocks against it.
DEFAULT_SMEM_BYTES = 48 * 1024


def walkers_for(rank_block: int) -> int:
    """Walkers per pass-one block: each walks a contiguous run of the
    chunk's slots with ``rank_block`` threads, one per rank column."""
    return max(1, THREADS // int(rank_block))


def smem_bytes(block_rows: int, rank_block: int) -> int:
    """Dynamic shared memory of one pass-one block: the partial tile, one
    carry row per walker and each walker's carry row id."""
    k = walkers_for(rank_block)
    return (block_rows * rank_block + k * rank_block) * 4 + k * 4


def shared_memory_per_block(device) -> int:
    """Shared memory one block may use on ``device`` (opt-in maximum on
    CUDA; the no-opt-in default for the CPU plain path)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return DEFAULT_SMEM_BYTES
    props = torch.cuda.get_device_properties(dev)
    return int(getattr(props, "shared_memory_per_block_optin",
                       props.shared_memory_per_block))


def max_rank_block(block_rows: int, smem_limit: int) -> int:
    """Widest rank block whose pass-one block fits ``smem_limit`` bytes of
    shared memory and the thread limit (0 if not even one column fits)."""
    for rb in range(MAX_THREADS, 0, -1):
        if smem_bytes(block_rows, rb) <= smem_limit:
            return rb
    return 0


@dataclasses.dataclass(frozen=True)
class SlabChunks:
    """Chunk table of one packing: chunk c covers slabs
    ``[chunk_slab[c], chunk_slab[c+1])``, all of one row block; row block
    b owns chunks ``[rb_chunk_ptr[b], rb_chunk_ptr[b+1])``.  A batch's
    table (``stack_chunks``) has a leading lane dimension."""

    chunk_slab: torch.Tensor      # (NC+1,) or (B, NC+1) int32
    rb_chunk_ptr: torch.Tensor    # (num_row_blocks+1,) or (B, ...) int32
    chunk_slabs: int              # slabs per full chunk

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_slab.shape[-1]) - 1


def _chunk_table(rb_of, num_row_blocks: int, chunk_slabs: int):
    rb_of = np.asarray(rb_of, dtype=np.int64)
    G = len(rb_of)
    if G and np.any(np.diff(rb_of) < 0):
        raise ValueError("rb_of must be nondecreasing (see pack_slabs)")
    counts = np.bincount(rb_of, minlength=num_row_blocks)
    if len(counts) != num_row_blocks or counts.min() < 1:
        raise ValueError("every row block needs at least one slab")
    per_rb = -(-counts // int(chunk_slabs))
    rb_chunk_ptr = np.zeros(num_row_blocks + 1, dtype=np.int64)
    np.cumsum(per_rb, out=rb_chunk_ptr[1:])
    block_start = np.zeros(num_row_blocks, dtype=np.int64)
    np.cumsum(counts[:-1], out=block_start[1:])
    chunk_rb = np.repeat(np.arange(num_row_blocks), per_rb)
    rank = np.arange(len(chunk_rb)) - rb_chunk_ptr[chunk_rb]
    chunk_slab = np.append(block_start[chunk_rb] + rank * chunk_slabs, G)
    return chunk_slab.astype(np.int32), rb_chunk_ptr.astype(np.int32)


def slab_chunks(rb_of: np.ndarray, num_row_blocks: int, device,
                chunk_slabs: int = CHUNK_SLABS) -> SlabChunks:
    """Split each row block's run of slabs into chunks of at most
    ``chunk_slabs`` (host numpy, once per packing).  Chunks tile ``[0, G)``
    in order, so appended cap slabs never move a real chunk's boundary."""
    chunk_slab, ptr = _chunk_table(rb_of, num_row_blocks, chunk_slabs)
    return SlabChunks(torch.as_tensor(chunk_slab, device=device),
                      torch.as_tensor(ptr, device=device), int(chunk_slabs))


def stack_chunks(rb_ofs: Sequence[np.ndarray], num_row_blocks: int, device,
                 chunk_slabs: int = CHUNK_SLABS) -> SlabChunks:
    """The batched chunk table of B packings with one slab count G: each
    lane's own table, padded to the batch's largest chunk count with
    empty chunks ``[G, G)`` that no row block owns."""
    tables = [_chunk_table(r, num_row_blocks, chunk_slabs) for r in rb_ofs]
    if len({len(r) for r in rb_ofs}) != 1:
        raise ValueError("lanes must share one slab count (the bucket's slab cap)")
    width = max(len(cs) for cs, _ in tables)
    chunk_slab = np.stack([np.pad(cs, (0, width - len(cs)), mode="edge")
                           for cs, _ in tables])
    ptr = np.stack([p for _, p in tables])
    return SlabChunks(torch.as_tensor(chunk_slab, device=device),
                      torch.as_tensor(ptr, device=device), int(chunk_slabs))


def mttkrp_slab_plain(
    idx_packed: torch.Tensor,      # (W, G*T) int32
    vals_packed: torch.Tensor,     # (1, G*T) float32
    lrows_packed: torch.Tensor,    # (1, G*T) int32
    rb_of: torch.Tensor,           # (G,) int32
    factors: Sequence[torch.Tensor],
    *,
    num_row_blocks: int,
    block_rows: int,
    tile: int,
) -> torch.Tensor:
    """Plain PyTorch version: ``(num_row_blocks*block_rows, R)`` float32."""
    prod = vals_packed[0].to(torch.float32)[:, None]
    for w, fac in enumerate(factors):
        prod = prod * fac.index_select(0, idx_packed[w].long()).to(torch.float32)
    rows = (lrows_packed[0].long()
            + torch.repeat_interleave(rb_of.long(), tile) * block_rows)
    out = torch.zeros((num_row_blocks * block_rows, prod.shape[1]),
                      dtype=torch.float32, device=prod.device)
    return out.index_add_(0, rows, prod)


def mttkrp_slab_batched_plain(
    idx_packed: torch.Tensor,      # (B, W, G*T) int32
    vals_packed: torch.Tensor,     # (B, 1, G*T) float32
    lrows_packed: torch.Tensor,    # (B, 1, G*T) int32
    rb_of: torch.Tensor,           # (B, G) int32
    factors: Sequence[torch.Tensor],   # W tensors (B, I_w, R)
    *,
    num_row_blocks: int,
    block_rows: int,
    tile: int,
) -> torch.Tensor:
    """Plain PyTorch version over a batch: ``(B, num_row_blocks*block_rows,
    R)`` float32.  The lanes are flattened into one gather and one
    ``index_add_`` with lane-offset rows, so each output row sums its own
    lane's slots in slot order, as ``mttkrp_slab_plain`` does per lane."""
    B, _, slots = idx_packed.shape
    out_rows = num_row_blocks * block_rows
    lane = torch.arange(B, device=idx_packed.device).repeat_interleave(slots)
    prod = vals_packed.reshape(-1).to(torch.float32)[:, None]
    for w, fac in enumerate(factors):
        rows_w = idx_packed[:, w].reshape(-1).long() + lane * fac.shape[1]
        prod = prod * fac.reshape(-1, fac.shape[-1]).index_select(
            0, rows_w).to(torch.float32)
    rows = (lrows_packed.reshape(-1).long()
            + rb_of.long().repeat_interleave(tile, dim=1).reshape(-1) * block_rows
            + lane * out_rows)
    out = torch.zeros((B * out_rows, prod.shape[1]), dtype=torch.float32,
                      device=prod.device)
    return out.index_add_(0, rows, prod).reshape(B, out_rows, -1)


def scatter_slab_values(values: torch.Tensor, val_scatter: torch.Tensor,
                        slots: int) -> torch.Tensor:
    """Kernel-ready slab values from run-time values: ``values`` (..., nnz)
    in layout order go to their packed slots ``val_scatter`` (..., nnz,
    int64) of a zero ``(..., 1, slots)`` float32 array; every other slot
    (slab padding, cap slabs) stays +0.0."""
    out = torch.zeros(values.shape[:-1] + (slots,), dtype=torch.float32,
                      device=values.device)
    return out.scatter_(-1, val_scatter, values.to(torch.float32)).unsqueeze(-2)


def _check(name, t, dtype, device, ndim):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor")


def _check_factors(factors, device, ndim):
    fdtype = factors[0].dtype
    if fdtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"factors must be float32 or bfloat16, got {fdtype}")
    R = int(factors[0].shape[-1])
    for w, f in enumerate(factors):
        _check(f"factors[{w}]", f, fdtype, device, ndim)
        if int(f.shape[-1]) != R:
            raise ValueError("all factors must have the same rank")
    return fdtype, R


def _launch(entry, idx_packed, vals_packed, lrows_packed, factors, chunks,
            *, batch, num_row_blocks, block_rows, tile, rank_block, slots):
    """Check what every entry shares, launch both passes on the current
    stream and count the launch under ``entry``.  ``batch=None`` is one
    packing; an int B means every array carries a leading lane dimension
    of B, and the lane strides follow from the shapes."""
    device = idx_packed.device
    W = len(factors)
    if not 1 <= W <= MAX_INPUTS:
        raise ValueError(f"the kernel takes 1..{MAX_INPUTS} input factors, got {W}")
    lanes = () if batch is None else (batch,)
    lead = len(lanes)
    fdtype, R = _check_factors(factors, device, 2 + lead)
    if chunks is None:
        raise ValueError("the CUDA kernel needs the packing's chunk table (slab_chunks)")
    _check("chunks.chunk_slab", chunks.chunk_slab, torch.int32, device, 1 + lead)
    _check("chunks.rb_chunk_ptr", chunks.rb_chunk_ptr, torch.int32, device, 1 + lead)
    if int(chunks.rb_chunk_ptr.shape[-1]) != num_row_blocks + 1:
        raise ValueError("chunk table does not match num_row_blocks")
    if lead and (int(chunks.chunk_slab.shape[0]) != batch
                 or int(chunks.rb_chunk_ptr.shape[0]) != batch):
        raise ValueError("chunk table does not match the batch")
    if rank_block is None or rank_block >= R:
        rank_block = R
    if rank_block < 1:
        raise ValueError(f"rank_block must be >= 1, got {rank_block}")
    smem_limit = shared_memory_per_block(device)
    if rank_block > MAX_THREADS or smem_bytes(block_rows, rank_block) > smem_limit:
        raise ValueError(
            f"rank_block {rank_block} at block_rows {block_rows} exceeds the "
            f"block's threads or shared memory ({smem_limit} bytes)")
    r_pad = -(-R // rank_block) * rank_block
    out_rows = num_row_blocks * block_rows
    partials = torch.empty(lanes + (chunks.num_chunks, block_rows, r_pad),
                           dtype=torch.float32, device=device)
    out = torch.empty(lanes + (out_rows, r_pad), dtype=torch.float32, device=device)

    from .build import load_library   # builds with nvcc at first use

    lib = load_library()
    ptrs = (ctypes.c_void_p * MAX_INPUTS)(*[f.data_ptr() for f in factors])
    strides = (ctypes.c_longlong * MAX_INPUTS)(
        *[int(f.shape[-2]) * R if lead else 0 for f in factors])
    err = lib.mttkrp_slab_launch(
        device.index, batch or 1,
        chunks.chunk_slab.data_ptr(), chunks.rb_chunk_ptr.data_ptr(),
        chunks.num_chunks, num_row_blocks, chunks.chunk_slabs,
        idx_packed.data_ptr(), vals_packed.data_ptr(), lrows_packed.data_ptr(),
        ctypes.addressof(ptrs), ctypes.addressof(strides), W,
        int(fdtype == torch.bfloat16), R, slots, tile, block_rows, rank_block,
        r_pad, walkers_for(rank_block), partials.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(
            f"{entry} launch failed: {lib.mttkrp_slab_error_string(err).decode()}")
    LAUNCHES[entry] += 1
    return out if r_pad == R else out[..., :R]


def _check_device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (run the plain version); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _check_slab_arrays(idx_packed, vals_packed, lrows_packed, rb_of, W, tile,
                       lead: tuple):
    device = idx_packed.device
    G = int(rb_of.shape[-1])
    slots = G * int(tile)
    _check("idx_packed", idx_packed, torch.int32, device, 2 + len(lead))
    _check("vals_packed", vals_packed, torch.float32, device, 2 + len(lead))
    _check("lrows_packed", lrows_packed, torch.int32, device, 2 + len(lead))
    _check("rb_of", rb_of, torch.int32, device, 1 + len(lead))
    if tuple(idx_packed.shape) != lead + (W, slots):
        raise ValueError(f"idx_packed is {tuple(idx_packed.shape)}, "
                         f"expected {lead + (W, slots)}")
    if (tuple(vals_packed.shape) != lead + (1, slots)
            or tuple(lrows_packed.shape) != lead + (1, slots)):
        raise ValueError("vals_packed and lrows_packed must be (..., 1, G*tile)")
    return slots


def mttkrp_slab(
    idx_packed: torch.Tensor,
    vals_packed: torch.Tensor,
    lrows_packed: torch.Tensor,
    rb_of: torch.Tensor,
    factors: Sequence[torch.Tensor],
    *,
    chunks: SlabChunks | None,
    num_row_blocks: int,
    block_rows: int,
    tile: int,
    rank_block: int | None = None,
) -> torch.Tensor:
    """Segmented MTTKRP of one packed mode: ``(num_row_blocks*block_rows, R)``
    float32 in relabeled row order.

    CUDA tensors launch the kernel on ``torch.cuda.current_stream()``;
    ``rank_block`` tiles the rank (padded to a multiple of it, then
    sliced).  CPU tensors run ``mttkrp_slab_plain`` (``chunks`` and
    ``rank_block`` do not change the result and are ignored there)."""
    if not _check_device(idx_packed):
        return mttkrp_slab_plain(
            idx_packed, vals_packed, lrows_packed, rb_of, factors,
            num_row_blocks=num_row_blocks, block_rows=block_rows, tile=tile)
    slots = _check_slab_arrays(idx_packed, vals_packed, lrows_packed, rb_of,
                               len(factors), tile, ())
    return _launch("mttkrp_slab", idx_packed, vals_packed, lrows_packed,
                   list(factors), chunks, batch=None,
                   num_row_blocks=num_row_blocks, block_rows=block_rows,
                   tile=tile, rank_block=rank_block, slots=slots)


def mttkrp_slab_valued(
    idx_packed: torch.Tensor,
    values: torch.Tensor,          # (nnz,) float32, layout order
    val_scatter: torch.Tensor,     # (nnz,) int64 packed slot of each entry
    lrows_packed: torch.Tensor,
    rb_of: torch.Tensor,
    factors: Sequence[torch.Tensor],
    *,
    chunks: SlabChunks | None,
    num_row_blocks: int,
    block_rows: int,
    tile: int,
    rank_block: int | None = None,
) -> torch.Tensor:
    """``mttkrp_slab`` with values supplied at run time: ``values`` are
    scattered into a zero slab value array (``scatter_slab_values``, plain
    PyTorch on the same device, outside the kernel as on the TPU path),
    then the kernel runs on it.  Slots whose value is exactly +-0.0 add
    nothing, so weight-0 residuals are exact no-ops."""
    slots = int(rb_of.shape[-1]) * int(tile)
    vals_packed = scatter_slab_values(values, val_scatter, slots)
    if not _check_device(idx_packed):
        return mttkrp_slab_plain(
            idx_packed, vals_packed, lrows_packed, rb_of, factors,
            num_row_blocks=num_row_blocks, block_rows=block_rows, tile=tile)
    _check_slab_arrays(idx_packed, vals_packed, lrows_packed, rb_of,
                       len(factors), tile, ())
    return _launch("mttkrp_slab_valued", idx_packed, vals_packed, lrows_packed,
                   list(factors), chunks, batch=None,
                   num_row_blocks=num_row_blocks, block_rows=block_rows,
                   tile=tile, rank_block=rank_block, slots=slots)


def mttkrp_slab_batched(
    idx_packed: torch.Tensor,      # (B, W, G*T) int32
    vals_packed: torch.Tensor,     # (B, 1, G*T) float32
    lrows_packed: torch.Tensor,    # (B, 1, G*T) int32
    rb_of: torch.Tensor,           # (B, G) int32
    factors: Sequence[torch.Tensor],   # W tensors (B, I_w, R)
    *,
    chunks: SlabChunks | None,     # from stack_chunks
    num_row_blocks: int,
    block_rows: int,
    tile: int,
    rank_block: int | None = None,
) -> torch.Tensor:
    """MTTKRP of one mode for B packings sharing one slab cap and tiling,
    in one launch: ``(B, num_row_blocks*block_rows, R)`` float32.  Lane b
    is bitwise ``mttkrp_slab`` on lane b's packing.  CPU tensors run
    ``mttkrp_slab_batched_plain``."""
    if not _check_device(idx_packed):
        return mttkrp_slab_batched_plain(
            idx_packed, vals_packed, lrows_packed, rb_of, factors,
            num_row_blocks=num_row_blocks, block_rows=block_rows, tile=tile)
    B = int(idx_packed.shape[0])
    slots = _check_slab_arrays(idx_packed, vals_packed, lrows_packed, rb_of,
                               len(factors), tile, (B,))
    if any(int(f.shape[0]) != B for f in factors):
        raise ValueError("every factor needs one slice per lane")
    return _launch("mttkrp_slab_batched", idx_packed, vals_packed, lrows_packed,
                   list(factors), chunks, batch=B,
                   num_row_blocks=num_row_blocks, block_rows=block_rows,
                   tile=tile, rank_block=rank_block, slots=slots)
