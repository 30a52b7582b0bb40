"""Slab-packed segmented spMTTKRP: the Hopper kernel's wrapper and plain version.

Counterpart of ``repro/kernels/mttkrp_pallas.py`` (the TPU kernel
``_kernel``, launched by ``mttkrp_pallas()`` at its ``pl.pallas_call``).
It computes the same function on the same packed arrays
(``kernels.ops.pack_slabs``)::

    out[rb_of[g] * block_rows + lrow] += val * prod_w F_w[idx_w]

over every packed slot of every slab g, accumulated in float32 whatever
the factors' type (float32 or bfloat16).

* ``mttkrp_slab`` launches the CUDA kernel (``csrc/mttkrp_slab.cu``) for
  CUDA tensors and adds one to ``LAUNCHES`` per launch.  For CPU tensors
  it runs ``mttkrp_slab_plain``: that is the only way the plain version is
  reached from the wrapper.
* ``mttkrp_slab_plain`` is the same function in plain PyTorch (gather,
  Hadamard, ``index_add_``).  The CPU tests and ``chip_smoke.py`` hold the
  kernel against it.

The kernel has no ordered grid, so it runs in two passes: pass one
reduces each *chunk* (a run of at most ``chunk_slabs`` slabs of one row
block) into a partial ``(block_rows, rank_block)`` tile, and pass two adds
the partials of each row block in chunk order.  ``slab_chunks`` builds the
chunk table on the host once per packing.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

# Kernel launches made through ``mttkrp_slab`` in this process (one per
# wrapper call that launches the kernel; CPU calls do not count).
LAUNCHES = 0

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
    b owns chunks ``[rb_chunk_ptr[b], rb_chunk_ptr[b+1])``."""

    chunk_slab: torch.Tensor      # (NC+1,) int32
    rb_chunk_ptr: torch.Tensor    # (num_row_blocks+1,) int32
    chunk_slabs: int              # slabs per full chunk

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_slab.shape[0]) - 1


def slab_chunks(rb_of: np.ndarray, num_row_blocks: int, device,
                chunk_slabs: int = CHUNK_SLABS) -> SlabChunks:
    """Split each row block's run of slabs into chunks of at most
    ``chunk_slabs`` (host numpy, once per packing).  Chunks tile ``[0, G)``
    in order, so appended cap slabs never move a real chunk's boundary."""
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
    return SlabChunks(
        torch.as_tensor(chunk_slab.astype(np.int32), device=device),
        torch.as_tensor(rb_chunk_ptr.astype(np.int32), device=device),
        int(chunk_slabs))


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


def _check(name, t, dtype, device, ndim):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor")


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
    global LAUNCHES
    device = idx_packed.device
    if device.type == "cpu":
        return mttkrp_slab_plain(
            idx_packed, vals_packed, lrows_packed, rb_of, factors,
            num_row_blocks=num_row_blocks, block_rows=block_rows, tile=tile)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    W = len(factors)
    if not 1 <= W <= MAX_INPUTS:
        raise ValueError(f"the kernel takes 1..{MAX_INPUTS} input factors, got {W}")
    G = int(rb_of.shape[0])
    slots = G * int(tile)
    _check("idx_packed", idx_packed, torch.int32, device, 2)
    _check("vals_packed", vals_packed, torch.float32, device, 2)
    _check("lrows_packed", lrows_packed, torch.int32, device, 2)
    _check("rb_of", rb_of, torch.int32, device, 1)
    if tuple(idx_packed.shape) != (W, slots):
        raise ValueError(f"idx_packed is {tuple(idx_packed.shape)}, expected {(W, slots)}")
    if tuple(vals_packed.shape) != (1, slots) or tuple(lrows_packed.shape) != (1, slots):
        raise ValueError("vals_packed and lrows_packed must be (1, G*tile)")
    fdtype = factors[0].dtype
    if fdtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"factors must be float32 or bfloat16, got {fdtype}")
    R = int(factors[0].shape[1])
    for w, f in enumerate(factors):
        _check(f"factors[{w}]", f, fdtype, device, 2)
        if int(f.shape[1]) != R:
            raise ValueError("all factors must have the same rank")
    if chunks is None:
        raise ValueError("the CUDA kernel needs the packing's chunk table (slab_chunks)")
    _check("chunks.chunk_slab", chunks.chunk_slab, torch.int32, device, 1)
    _check("chunks.rb_chunk_ptr", chunks.rb_chunk_ptr, torch.int32, device, 1)
    if int(chunks.rb_chunk_ptr.shape[0]) != num_row_blocks + 1:
        raise ValueError("chunk table does not match num_row_blocks")
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
    partials = torch.empty((chunks.num_chunks, block_rows, r_pad),
                           dtype=torch.float32, device=device)
    out = torch.empty((num_row_blocks * block_rows, r_pad),
                      dtype=torch.float32, device=device)

    from .build import load_library   # builds with nvcc at first use

    lib = load_library()
    ptrs = (ctypes.c_void_p * MAX_INPUTS)(*[f.data_ptr() for f in factors])
    err = lib.mttkrp_slab_launch(
        device.index,
        chunks.chunk_slab.data_ptr(), chunks.rb_chunk_ptr.data_ptr(),
        chunks.num_chunks, num_row_blocks, chunks.chunk_slabs,
        idx_packed.data_ptr(), vals_packed.data_ptr(), lrows_packed.data_ptr(),
        ctypes.addressof(ptrs), W, int(fdtype == torch.bfloat16),
        R, slots, tile, block_rows, rank_block, r_pad, walkers_for(rank_block),
        partials.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(
            f"mttkrp_slab launch failed: {lib.mttkrp_slab_error_string(err).decode()}")
    LAUNCHES += 1
    return out if r_pad == R else out[:, :R]
