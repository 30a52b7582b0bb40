"""Static-shape partition plans (port of ``repro.core.plan``, less the
distributed and pod parts).

  * ``quantize_nnz`` -- the nnz cap of a (shape, nnz-bucket) class;
    ``session_cap`` -- a streaming session's monotone cap over it.
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

Serving feedback.  ``plan_bucket(density=)`` takes per-mode row-density
profiles observed by ``serve.metrics`` (``density_profile``) and prices
the segment backend's partitioning against them
(``choose_segment_partition``), exactly as the reference does; that moves
``ModePlan.seg_kappa`` / ``seg_scheme`` only.  The reference also reprices
its TPU tile choice there; the port's tiling has no cost model, so a
profile leaves tiles, rank blocks and slab caps as they are.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..kernels import ops as kops
from ..kernels.mttkrp_slab import DEFAULT_SMEM_BYTES, max_rank_block
from ..obs import trace as obs_trace


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


def session_cap(nnz: int, current_cap: int, policy) -> int:
    """Monotone per-session bucket cap: quantize ``nnz`` through
    ``policy`` (any object with an ``nnz_cap(nnz)`` rule, i.e. a
    ``serve.buckets.BucketPolicy``) but never below the session's
    ``current_cap``.  Shrinking the cap after an eviction would present
    new array shapes to the engine; holding it keeps some zero-weight
    padding slots instead.  With geometric bucketing a session sees
    O(log peak nnz) classes over its lifetime."""
    return max(int(current_cap), int(policy.nnz_cap(nnz)))


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
    # Segment-backend partitioning for this mode: the number of partitions
    # and the load-balancing scheme ('index' / 'nnz'; None = the adaptive
    # threshold rule).  Without a density profile it is the caller's kappa
    # untouched; an observed profile routes through
    # ``choose_segment_partition``.
    seg_kappa: int = 1
    seg_scheme: str | None = None

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


class _UniformModeStats:
    """Stand-in for a ``ModeLayout`` when no tensor data exists yet
    (bucket-level planning): ``nnz_cap`` nonzeros spread uniformly over
    the mode's rows."""

    def __init__(self, shape: tuple[int, ...], mode: int, nnz: int):
        self.shape = tuple(int(s) for s in shape)
        self.mode = int(mode)
        self.num_rows = self.shape[mode]
        self.nnz = int(nnz)
        self.nmodes = len(self.shape)
        self.row_ptr = np.round(
            np.linspace(0.0, self.nnz, self.num_rows + 1)
        ).astype(np.int64)

    def input_modes(self):
        return [w for w in range(self.nmodes) if w != self.mode]


DENSITY_BINS = 8

# Segment-backend partition chooser (relative cost units of "one nnz of
# segmented-reduction work"): per-partition fixed overhead and per-output-row
# combine cost.
SEG_PART_OVERHEAD = 16.0     # beta: nnz-equivalents per extra partition
SEG_COMBINE_COST = 1.0       # gamma: nnz-equivalents per combined output row


class _ObservedModeStats(_UniformModeStats):
    """Bucket-planning stand-in built from an observed row-density
    profile: ``profile`` is the fraction of nnz mass in each of
    ``DENSITY_BINS`` equal row-count bins of the descending-sorted row
    loads (``serve.metrics`` accumulates it per bucket).  Rows within a
    bin share its mass, so ``row_ptr`` reproduces the stream's skew at bin
    granularity."""

    def __init__(self, shape, mode, nnz, profile):
        super().__init__(shape, mode, nnz)
        masses = np.asarray(profile, dtype=np.float64)
        if masses.ndim != 1 or masses.size != DENSITY_BINS:
            raise ValueError(
                f"density profile must have {DENSITY_BINS} bins, got "
                f"{masses.shape}")
        masses = np.maximum(masses, 0.0)
        total = masses.sum()
        masses = (masses / total) if total > 0 else np.full(
            DENSITY_BINS, 1.0 / DENSITY_BINS)
        edges = np.round(np.linspace(0, self.num_rows,
                                     DENSITY_BINS + 1)).astype(np.int64)
        loads = np.zeros(self.num_rows, dtype=np.float64)
        for b in range(DENSITY_BINS):
            lo, hi = edges[b], edges[b + 1]
            if hi > lo:
                loads[lo:hi] = masses[b] * self.nnz / (hi - lo)
        row_ptr = np.zeros(self.num_rows + 1, dtype=np.float64)
        np.cumsum(loads, out=row_ptr[1:])
        self.row_ptr = np.round(row_ptr).astype(np.int64)


def density_profile(indices: np.ndarray, shape, mode: int,
                    bins: int = DENSITY_BINS) -> tuple[float, ...]:
    """Observed row-density profile of one tensor along ``mode``: fraction
    of nnz mass per equal-row-count bin of the descending-sorted row
    loads."""
    num_rows = int(shape[mode])
    counts = np.sort(np.bincount(indices[:, mode],
                                 minlength=num_rows))[::-1]
    total = counts.sum()
    if total == 0:
        return tuple([1.0 / bins] * bins)
    edges = np.round(np.linspace(0, num_rows, bins + 1)).astype(np.int64)
    return tuple(
        float(counts[edges[b]:edges[b + 1]].sum() / total)
        for b in range(bins)
    )


def _lpt_makespan(loads: np.ndarray, kappa: int) -> float:
    """Max partition load of the greedy LPT assignment of descending
    ``loads`` onto ``kappa`` partitions (``load_balance.partition_mode``'s
    rule, priced without building a layout)."""
    if kappa <= 1:
        return float(loads.sum())
    import heapq

    heap = [0.0] * kappa
    for v in loads:
        heapq.heapreplace(heap, heap[0] + float(v))
    return float(max(heap))


def choose_segment_partition(stats, kappa_max: int) -> tuple[int, str]:
    """Pick (kappa, scheme) for the segment backend from a mode's row-load
    distribution: the argmin over kappa in {1, 2, 4, ..., kappa_max} of
    scheme 'index' (LPT makespan + ``SEG_PART_OVERHEAD`` per partition)
    and scheme 'nnz' (``nnz / kappa`` + ``SEG_COMBINE_COST`` per output
    row + the same overhead)."""
    loads = np.sort(np.diff(stats.row_ptr))[::-1].astype(np.float64)
    nnz = float(loads.sum())
    best = (float("inf"), 1, "index")
    k = 1
    while k <= max(1, int(kappa_max)):
        over = SEG_PART_OVERHEAD * k
        c1 = _lpt_makespan(loads, k) + over
        c2 = (nnz / k
              + (SEG_COMBINE_COST * stats.num_rows if k > 1 else 0.0)
              + over)
        if c1 < best[0]:
            best = (c1, k, "index")
        if c2 < best[0]:
            best = (c2, k, "nnz")
        k *= 2
    _, k, scheme = best
    if scheme == "index" and stats.num_rows < k:
        scheme = "nnz"
    return k, scheme


def _mode_plan(num_rows: int, mode: int, rank: int, nnz_cap: int, *,
               block_rows: int | None, tile: int | None,
               rank_block: int | None, smem_limit: int,
               num_inputs: int, seg_kappa: int = 1,
               seg_scheme: str | None = None) -> ModePlan:
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
        seg_kappa=int(seg_kappa),
        seg_scheme=seg_scheme,
    )


@functools.lru_cache(maxsize=None)
def plan_bucket(shape: tuple[int, ...], nnz_cap: int, rank: int,
                kappa: int = 1, *, block_rows: int | None = None,
                tile: int | None = None, rank_block: int | None = None,
                smem_limit: int = DEFAULT_SMEM_BYTES,
                density: tuple | None = None) -> PartitionPlan:
    """Static plan for a (shape, nnz_cap) bucket class -- no tensor data.
    ``smem_limit`` is the shared memory one block may use on the target
    device (``kernels.mttkrp_slab.shared_memory_per_block``).
    ``density`` -- a per-mode tuple of ``DENSITY_BINS`` observed row-mass
    fractions (or None per mode), fed back from ``serve.metrics`` --
    prices the segment partitioning against the stream's skew.  Cached:
    callers quantize the profile so the cache stays small."""
    shape = tuple(int(s) for s in shape)
    if density is not None and len(density) != len(shape):
        raise ValueError(
            f"density must carry one profile per mode ({len(shape)}), got "
            f"{len(density)}")
    modes = []
    for d in range(len(shape)):
        if density is not None and density[d] is not None:
            stats = _ObservedModeStats(shape, d, nnz_cap, density[d])
            seg = choose_segment_partition(stats, max(int(kappa), DENSITY_BINS))
        else:
            seg = (max(1, int(kappa)), None)
        modes.append(_mode_plan(
            shape[d], d, rank, nnz_cap, block_rows=block_rows, tile=tile,
            rank_block=rank_block, smem_limit=smem_limit,
            num_inputs=max(1, len(shape) - 1), seg_kappa=seg[0],
            seg_scheme=seg[1]))
    plan = PartitionPlan(shape=shape, nnz_cap=int(nnz_cap), rank=int(rank),
                         kappa=int(kappa), modes=tuple(modes))
    # Inside the cached body: the event fires once per novel bucket class.
    obs_trace.event(
        "plan.build", cat="plan", shape=str(shape), nnz_cap=int(nnz_cap),
        rank=int(rank), kappa=int(kappa),
        observed_density=density is not None, plan=plan.describe(),
        tiles=[{"mode": m.mode, "block_rows": m.block_rows, "tile": m.tile,
                "rank_block": m.rank_block, "slab_cap": m.slab_cap,
                "seg_kappa": m.seg_kappa, "seg_scheme": m.seg_scheme}
               for m in plan.modes])
    return plan


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
