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
block) into a partial ``(block_rows, rank_block)`` tile, and pass two sums
each row block's partials in groups of ``GROUP_CHUNKS`` consecutive
chunks, then the group sums in group order.  ``slab_chunks`` builds the
chunk and group tables on the host once per packing, ``stack_chunks``
the padded tables of a batch.  ``launch_config`` chooses pass one's
shape: columns per thread, walkers, the slot-stream ring's stage and the
small factors held in shared memory (``staged_inputs``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

# Kernel launches made through each wrapper in this process (CPU calls do
# not count).
LAUNCHES = {"mttkrp_slab": 0, "mttkrp_slab_valued": 0, "mttkrp_slab_batched": 0}

THREADS = 256          # target threads per pass-one block
MAX_THREADS = 1024     # hardware limit per block
MAX_WALKERS = 64       # walkers per pass-one block
MAX_INPUTS = 7         # input modes the kernel is instantiated for
CHUNK_SLABS = 16       # slabs per chunk (a fixed size keeps cap padding exact)
GROUP_CHUNKS = 16      # chunks per group of pass two
STAGE_SLOTS = 512      # slots of one slot-stream ring stage, over all walkers
RING_STAGES = 2        # buffers of the ring (csrc kRingStages)
STAGED_FACTOR_BYTES = 32 * 1024   # shared memory for small factors, per block
# Shared memory a block may use without opting in; the CPU plan sizes
# rank blocks against it.
DEFAULT_SMEM_BYTES = 48 * 1024


def columns_per_thread(rank_block: int, rank: int | None = None) -> int:
    """Rank columns one pass-one thread owns: 4 (one 16-byte gather) when
    the rank block and the factors' row stride ``rank`` hold whole groups
    of four columns, else 1."""
    return 4 if rank_block % 4 == 0 and (rank is None or rank % 4 == 0) else 1


def walkers_for(rank_block: int, cols: int | None = None) -> int:
    """Walkers per pass-one block: each walks a contiguous run of the
    chunk's slots with ``rank_block / cols`` threads, ``cols`` rank
    columns each (default: ``columns_per_thread(rank_block)``)."""
    cols = columns_per_thread(rank_block) if cols is None else cols
    return max(1, min(MAX_WALKERS, THREADS // (int(rank_block) // cols)))


def stage_slots_for(walkers: int) -> int:
    """Slots of each walker's run that one ring stage holds (a multiple
    of the walker's 4-slot step)."""
    return max(4, STAGE_SLOTS // walkers // 4 * 4)


def smem_bytes(block_rows: int, rank_block: int, cols: int | None = None,
               num_inputs: int = MAX_INPUTS) -> int:
    """Dynamic shared memory of one pass-one block before its staged
    factors: the ring of ``RING_STAGES`` stages of the ``num_inputs + 2``
    slot streams, the partial tile, one carry row per walker and each
    walker's carry row id (padded to 16 bytes).  The default
    ``num_inputs`` is the largest, for plans made before the input count
    is known."""
    k = walkers_for(rank_block, cols)
    ring = RING_STAGES * (num_inputs + 2) * k * stage_slots_for(k)
    return 4 * (ring + block_rows * rank_block + k * rank_block + -(-k // 4) * 4)


def staged_inputs(factor_rows: Sequence[int], rank_block: int,
                  budget: int = STAGED_FACTOR_BYTES) -> int:
    """Bit mask of the input factors whose ``rank_block`` columns (float32
    in shared memory) fit ``budget`` bytes together, taken smallest first
    (ties by position); the rest are gathered from device memory."""
    mask, used = 0, 0
    for w in sorted(range(len(factor_rows)), key=lambda w: (factor_rows[w], w)):
        need = int(factor_rows[w]) * int(rank_block) * 4
        if used + need > budget:
            break
        mask, used = mask | (1 << w), used + need
    return mask


@dataclasses.dataclass(frozen=True)
class SlabConfig:
    """Shape parameters of one pass-one launch (``launch_config``)."""

    cols: int              # rank columns per thread (1 or 4)
    walkers: int
    stage_slots: int       # slots per walker per ring stage
    staged_mask: int       # inputs held in shared memory
    smem: int              # dynamic shared memory bytes, staged factors included
    threads: int


def launch_config(rank: int, rank_block: int, block_rows: int,
                  factor_rows: Sequence[int], *, aligned: bool = True,
                  smem_limit: int = DEFAULT_SMEM_BYTES) -> SlabConfig:
    """The pass-one launch for factors of ``factor_rows`` rows at this
    rank and rank block: wide columns when the shape (and, ``aligned``,
    the factors' addresses) allow them, and as many of the smallest
    factors staged as fit ``STAGED_FACTOR_BYTES`` and what ``smem_limit``
    leaves after the ring, tile and carries."""
    return _launch_config(int(rank), int(rank_block), int(block_rows),
                          tuple(int(r) for r in factor_rows), bool(aligned),
                          int(smem_limit))


@functools.lru_cache(maxsize=None)
def _launch_config(rank, rank_block, block_rows, factor_rows, aligned, smem_limit):
    cols = columns_per_thread(rank_block, rank) if aligned else 1
    walkers = walkers_for(rank_block, cols)
    base = smem_bytes(block_rows, rank_block, cols, len(factor_rows))
    mask = staged_inputs(factor_rows, rank_block,
                         min(STAGED_FACTOR_BYTES, smem_limit - base))
    staged = sum(int(r) * rank_block * 4 for w, r in enumerate(factor_rows)
                 if mask >> w & 1)
    return SlabConfig(cols=cols, walkers=walkers,
                      stage_slots=stage_slots_for(walkers), staged_mask=mask,
                      smem=base + staged, threads=walkers * (rank_block // cols))


def shared_memory_per_block(device) -> int:
    """Shared memory one block may use on ``device`` (opt-in maximum on
    CUDA; the no-opt-in default for the CPU plain path)."""
    return _shared_memory_per_block(torch.device(device))


@functools.lru_cache(maxsize=None)
def _shared_memory_per_block(dev: torch.device) -> int:
    if dev.type != "cuda":
        return DEFAULT_SMEM_BYTES
    props = torch.cuda.get_device_properties(dev)
    return int(getattr(props, "shared_memory_per_block_optin",
                       props.shared_memory_per_block))


def max_rank_block(block_rows: int, smem_limit: int,
                   num_inputs: int = MAX_INPUTS, widest: int = MAX_THREADS) -> int:
    """Widest rank block of at most ``widest`` columns whose pass-one
    block, for ``num_inputs`` input factors, fits ``smem_limit`` bytes of
    shared memory and the thread limit (0 if not even one column fits)."""
    for rb in range(min(int(widest), MAX_THREADS), 0, -1):
        if smem_bytes(block_rows, rb, num_inputs=num_inputs) <= smem_limit:
            return rb
    return 0


@dataclasses.dataclass(frozen=True)
class SlabChunks:
    """Chunk and group tables of one packing: chunk c covers slabs
    ``[chunk_slab[c], chunk_slab[c+1])``, all of one row block; row block
    b owns chunks ``[rb_chunk_ptr[b], rb_chunk_ptr[b+1])``.  Pass two sums
    group g's chunks ``[group_chunk[g], group_chunk[g+1])``, then row
    block b's groups ``[rb_group_ptr[b], rb_group_ptr[b+1])``.  A batch's
    tables (``stack_chunks``) have a leading lane dimension."""

    chunk_slab: torch.Tensor      # (NC+1,) or (B, NC+1) int32
    rb_chunk_ptr: torch.Tensor    # (num_row_blocks+1,) or (B, ...) int32
    group_chunk: torch.Tensor     # (NG+1,) or (B, NG+1) int32
    rb_group_ptr: torch.Tensor    # (num_row_blocks+1,) or (B, ...) int32
    chunk_slabs: int              # slabs per full chunk

    def __post_init__(self):
        tables = (self.chunk_slab, self.rb_chunk_ptr, self.group_chunk, self.rb_group_ptr)
        ndim = self.chunk_slab.dim()
        for t in tables:
            if (t.dtype != torch.int32 or t.dim() != ndim or not t.is_contiguous()
                    or t.device != self.chunk_slab.device):
                raise ValueError("chunk tables must be contiguous int32 tensors of one "
                                 "device and rank")

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_slab.shape[-1]) - 1

    @property
    def num_groups(self) -> int:
        return int(self.group_chunk.shape[-1]) - 1

    def numel(self) -> int:
        """Entries of the four tables (what the kernel reads of them)."""
        return sum(int(t.numel()) for t in (self.chunk_slab, self.rb_chunk_ptr,
                                            self.group_chunk, self.rb_group_ptr))


def _chunk_table(rb_of, num_row_blocks: int, chunk_slabs: int):
    """Split each row block's run of items (slabs, or chunks) into runs
    of at most ``chunk_slabs``, aligned to the row block's first item."""
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


def _tables(rb_of, num_row_blocks: int, chunk_slabs: int):
    """Chunk table, then the group table over its chunks."""
    chunk_slab, rb_chunk_ptr = _chunk_table(rb_of, num_row_blocks, chunk_slabs)
    chunk_rb = np.repeat(np.arange(num_row_blocks), np.diff(rb_chunk_ptr))
    group_chunk, rb_group_ptr = _chunk_table(chunk_rb, num_row_blocks, GROUP_CHUNKS)
    return chunk_slab, rb_chunk_ptr, group_chunk, rb_group_ptr


def slab_chunks(rb_of: np.ndarray, num_row_blocks: int, device,
                chunk_slabs: int = CHUNK_SLABS) -> SlabChunks:
    """Split each row block's run of slabs into chunks of at most
    ``chunk_slabs``, and its chunks into groups of ``GROUP_CHUNKS`` (host
    numpy, once per packing).  Chunks tile ``[0, G)`` in order, so
    appended cap slabs never move a real chunk's or group's boundary."""
    tables = _tables(rb_of, num_row_blocks, chunk_slabs)
    return SlabChunks(*[torch.as_tensor(t, device=device) for t in tables],
                      int(chunk_slabs))


def stack_chunks(rb_ofs: Sequence[np.ndarray], num_row_blocks: int, device,
                 chunk_slabs: int = CHUNK_SLABS) -> SlabChunks:
    """The batched tables of B packings with one slab count G: each lane's
    own tables, padded to the batch's largest chunk and group counts with
    empty chunks ``[G, G)`` and empty groups that no row block owns."""
    if len({len(r) for r in rb_ofs}) != 1:
        raise ValueError("lanes must share one slab count (the bucket's slab cap)")
    tables = [_tables(r, num_row_blocks, chunk_slabs) for r in rb_ofs]

    def padded(i):
        width = max(len(t[i]) for t in tables)
        return np.stack([np.pad(t[i], (0, width - len(t[i])), mode="edge")
                         for t in tables])

    return SlabChunks(*[torch.as_tensor(padded(i), device=device) for i in range(4)],
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
    """Check what every entry shares, launch pass one and pass two on the
    current stream and count the launch under ``entry``.  ``batch=None``
    is one packing; an int B means every array carries a leading lane
    dimension of B, and the lane strides follow from the shapes."""
    device = idx_packed.device
    W = len(factors)
    if not 1 <= W <= MAX_INPUTS:
        raise ValueError(f"the kernel takes 1..{MAX_INPUTS} input factors, got {W}")
    lanes = () if batch is None else (batch,)
    lead = len(lanes)
    _, R = _check_factors(factors, device, 2 + lead)
    if chunks is None:
        raise ValueError("the CUDA kernel needs the packing's chunk table (slab_chunks)")
    # SlabChunks checked its tables' type, contiguity and common device and rank.
    if chunks.chunk_slab.device != device or chunks.chunk_slab.dim() != 1 + lead:
        raise ValueError(f"chunk tables must be {1 + lead}-d on {device}")
    if lead and any(int(t.shape[0]) != batch for t in (
            chunks.chunk_slab, chunks.rb_chunk_ptr, chunks.group_chunk, chunks.rb_group_ptr)):
        raise ValueError("chunk table does not match the batch")
    if (int(chunks.rb_chunk_ptr.shape[-1]) != num_row_blocks + 1
            or int(chunks.rb_group_ptr.shape[-1]) != num_row_blocks + 1):
        raise ValueError("chunk table does not match num_row_blocks")
    if rank_block is None or rank_block >= R:
        rank_block = R
    if rank_block < 1:
        raise ValueError(f"rank_block must be >= 1, got {rank_block}")
    smem_limit = shared_memory_per_block(device)
    aligned = all(f.data_ptr() % (4 * f.element_size()) == 0 for f in factors)
    cfg = launch_config(R, rank_block, block_rows, [f.shape[-2] for f in factors],
                        aligned=aligned, smem_limit=smem_limit)
    if cfg.threads > MAX_THREADS or cfg.smem > smem_limit:
        raise ValueError(
            f"rank_block {rank_block} at block_rows {block_rows} exceeds the "
            f"block's threads or shared memory ({smem_limit} bytes)")
    from .build import load_library   # builds with nvcc at first use

    out = run_kernel(load_library(), cfg, idx_packed, vals_packed, lrows_packed,
                     factors, chunks, batch=batch, num_row_blocks=num_row_blocks,
                     block_rows=block_rows, tile=tile, rank_block=rank_block,
                     slots=slots)
    LAUNCHES[entry] += 1
    return out


def run_kernel(lib, cfg: SlabConfig, idx_packed, vals_packed, lrows_packed,
               factors, chunks, *, batch, num_row_blocks, block_rows, tile,
               rank_block, slots):
    """Launch both passes of ``lib`` with launch shape ``cfg`` on checked
    arguments (``_launch``); counts nothing."""
    device = idx_packed.device
    lanes = () if batch is None else (batch,)
    R = int(factors[0].shape[-1])
    stream_vec = tile % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (idx_packed, vals_packed, lrows_packed))
    r_pad = -(-R // rank_block) * rank_block
    out_rows = num_row_blocks * block_rows
    # One scratch allocation for the chunk partials and the group sums.
    n_part = chunks.num_chunks * (batch or 1) * block_rows * r_pad
    scratch = torch.empty(n_part + chunks.num_groups * (batch or 1) * block_rows * r_pad,
                          dtype=torch.float32, device=device)
    out = torch.empty(lanes + (out_rows, r_pad), dtype=torch.float32, device=device)
    W = len(factors)
    ptrs = (ctypes.c_void_p * MAX_INPUTS)(*[f.data_ptr() for f in factors])
    strides = (ctypes.c_longlong * MAX_INPUTS)(
        *[int(f.shape[-2]) * R if lanes else 0 for f in factors])
    rows = (ctypes.c_int * MAX_INPUTS)(*[int(f.shape[-2]) for f in factors])
    err = lib.mttkrp_slab_launch(
        device.index, batch or 1,
        chunks.chunk_slab.data_ptr(), chunks.num_chunks, chunks.chunk_slabs,
        chunks.group_chunk.data_ptr(), chunks.num_groups,
        chunks.rb_group_ptr.data_ptr(), num_row_blocks,
        idx_packed.data_ptr(), vals_packed.data_ptr(), lrows_packed.data_ptr(),
        slots, tile, int(stream_vec),
        ctypes.addressof(ptrs), ctypes.addressof(strides), ctypes.addressof(rows), W,
        int(factors[0].dtype == torch.bfloat16), R, block_rows, rank_block, r_pad,
        cfg.cols, cfg.walkers, cfg.stage_slots, cfg.staged_mask,
        scratch.data_ptr(), scratch[n_part:].data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(
            f"slab kernel launch failed: {lib.mttkrp_slab_error_string(err).decode()}")
    return out if r_pad == R else out[..., :R]


def blocks_per_sm(lib, cfg: SlabConfig, num_inputs: int, bf16: bool,
                  device) -> int:
    """Pass-one blocks of launch shape ``cfg`` resident on one SM of
    ``device`` (the CUDA occupancy calculator)."""
    n = lib.mttkrp_slab_blocks_per_sm(torch.device(device).index or 0, num_inputs,
                                      int(bf16), cfg.cols, cfg.threads, cfg.smem)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: "
                           f"{lib.mttkrp_slab_error_string(-n).decode()}")
    return n


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
