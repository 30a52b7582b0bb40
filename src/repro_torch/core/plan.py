"""Static-shape partition plans (port of ``repro.core.plan``).

  * ``quantize_nnz`` -- the nnz cap of a (shape, nnz-bucket) class;
    ``session_cap`` -- a streaming session's monotone cap over it.
  * ``slab_cap``     -- an nnz-independent upper bound on the packed grid
    size: any tensor with ``nnz <= nnz_cap`` packs into at most
    ``ceil(I_d / block_rows) + nnz_cap // tile`` slabs.
  * ``ModePlan`` / ``PartitionPlan`` -- the per-mode tiling decision.
  * ``PodPlan`` / ``plan_pod`` / ``pod_lane_order`` -- how a dispatched
    batch spreads over the ranks of a batch mesh (the pod path of
    ``serve.batched_engine``).
  * ``DeviceShards`` / ``build_device_shards`` / ``shard_fit_data`` --
    per-rank rectangular slices of a mode layout and of the fit data (the
    distributed engine, ``core.distributed``).

The pod and shard plans are host numpy, bitwise the reference's.

The tiling is the port's own.  ``(block_rows, tile)`` default to
(128, 256) unless pinned.  ``rank_block`` is the widest rank block whose
pass-one block of the slab kernel, for the mode's number of input
factors, fits the shared memory one block may use on the plan's device
(``kernels.mttkrp_slab.max_rank_block``); the JAX package's TPU cost
model (VMEM and MXU units) is not carried over.

A deliberate divergence from the reference: its plans price every
candidate tiling with its cost model (``auto_tiles``).  The port has a
Hopper-priced model of the slab kernel (``kernels.ops.auto_tiles``,
calibrated by ``obs.calibrate``), but ``_mode_plan`` does not consult
it: wiring it in would change every packing the port makes, which is a
speed change to be judged on a benchmark, not part of a port.

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
from .load_balance import Scheme

# Per-rank nnz shards are padded up to a multiple of this, so tensors of
# similar size share window functions.
DEVICE_SHARD_QUANTUM = 64


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
        rank_block = max_rank_block(block_rows, smem_limit, num_inputs,
                                    widest=rank)
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


# ---------------------------------------------------------------------------
# Pod plans (the batch-mesh path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PodPlan:
    """How a dispatched batch of one bucket class spreads over a batch
    mesh: every rank runs the same batched window on a ``B / num_devices``
    block of lanes.  ``dispatch_batch`` is the single sizing rule: the
    batch is rounded up to ``batch_quantum`` and then to a mesh multiple;
    the padding lanes repeat the last request and are discarded."""

    bucket: PartitionPlan
    num_devices: int
    batch_quantum: int = 1

    def dispatch_batch(self, batch: int) -> tuple[int, int]:
        """(total dispatched B, per-rank block) for ``batch`` requests."""
        if batch < 1:
            raise ValueError("batch must be >= 1")
        q = max(1, int(self.batch_quantum))
        tot = -(-int(batch) // q) * q
        n = max(1, int(self.num_devices))
        tot = -(-tot // n) * n
        return tot, tot // n


def plan_pod(shape: tuple[int, ...], nnz_cap: int, rank: int,
             kappa: int = 1, *, num_devices: int, batch_quantum: int = 1,
             density: tuple | None = None, **tiling) -> PodPlan:
    """Pod plan for a (shape, nnz_cap) bucket class: the bucket's
    ``plan_bucket`` plus the batch-mesh sizing.  ``tiling`` pins
    ``block_rows``/``tile``/``rank_block``/``smem_limit``."""
    return PodPlan(
        bucket=plan_bucket(tuple(int(s) for s in shape), int(nnz_cap),
                           int(rank), int(kappa), density=density, **tiling),
        num_devices=int(num_devices),
        batch_quantum=int(batch_quantum),
    )


def pod_lane_order(nnz: list[int], num_devices: int) -> list[int]:
    """Load-aware lane placement for the pod's contiguous split:
    ``order[lane] = request index`` such that rank ``p`` runs lanes
    ``order[p*per_dev:(p+1)*per_dev]``.  Requests are dealt heaviest
    first (descending nnz, index-stable), each to the least-loaded rank
    with a free lane; the identity is returned when that is no better
    balanced than arrival order, when the batch is not a mesh multiple,
    or when the mesh has one rank."""
    B = len(nnz)
    n = int(num_devices)
    identity = list(range(B))
    if n <= 1 or B == 0 or B % n:
        return identity
    per_dev = B // n
    ranked = sorted(identity, key=lambda i: (-int(nnz[i]), i))
    assign: list[list[int]] = [[] for _ in range(n)]
    loads = [0] * n
    for i in ranked:
        d = min((p for p in range(n) if len(assign[p]) < per_dev),
                key=lambda p: (loads[p], p))
        assign[d].append(i)
        loads[d] += int(nnz[i])
    order = [i for dev in assign for i in dev]
    if pod_imbalance(nnz, n, order) > pod_imbalance(nnz, n):
        return identity
    return order


def pod_device_nnz(nnz: list[int], num_devices: int,
                   order: list[int] | None = None) -> list[int]:
    """Per-rank total nnz under the contiguous split of ``order``
    (identity when None)."""
    B = len(nnz)
    n = max(1, int(num_devices))
    lanes = list(range(B)) if order is None else list(order)
    per_dev = max(1, B // n)
    return [int(sum(nnz[i] for i in lanes[p * per_dev:(p + 1) * per_dev]))
            for p in range(n)]


def pod_imbalance(nnz: list[int], num_devices: int,
                  order: list[int] | None = None) -> float:
    """Max/mean per-rank nnz (1.0 = perfectly balanced)."""
    loads = pod_device_nnz(nnz, num_devices, order)
    mean = sum(loads) / len(loads)
    return max(loads) / mean if mean > 0 else 1.0


# ---------------------------------------------------------------------------
# Per-rank shards (the distributed path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceShards:
    """Rectangular per-rank arrays of one mode (leading dim = kappa).

    Rows are GLOBAL relabeled rows: every rank computes a partial (I_d, R)
    output and a sum over the mesh combines them.  Scheme 1's partials
    have disjoint row support, scheme 2's overlap.  Padding entries carry
    value 0 on row ``I_d - 1``, so each shard's rows stay sorted.

    ``idx_full`` / ``ew`` (valued shards, the masked method): each shard
    entry's full coordinates and observation weight (0 on padding).
    ``own_rows`` / ``gather_map`` (scheme 1 only): each rank's owned
    relabeled rows padded to a common cap, and the original row each slot
    lands on (padding -> the dummy row I_d) -- the all-gather collective
    moves these slices instead of the whole partial."""

    scheme: Scheme
    mode: int
    num_rows: int              # I_d
    nnz_per_dev: int           # padded nnz per rank (static)
    idx: np.ndarray            # (kappa, nnz_per_dev, W) int32
    rows: np.ndarray           # (kappa, nnz_per_dev) int32 global relabeled
    vals: np.ndarray           # (kappa, nnz_per_dev) f32 (0 on padding)
    row_perm: np.ndarray       # (kappa, I_d) int32 (replicated copies)
    input_modes: tuple[int, ...]
    idx_full: np.ndarray | None = None   # (kappa, nnz_per_dev, N) int32
    ew: np.ndarray | None = None         # (kappa, nnz_per_dev) f32
    own_rows: np.ndarray | None = None   # (kappa, rows_cap) int32 relabeled
    gather_map: np.ndarray | None = None  # (kappa, rows_cap) int32 original

    @property
    def rows_cap(self) -> int:
        """Per-rank owned-row cap of the gather collective (0 when the
        scheme does not support it)."""
        return 0 if self.own_rows is None else int(self.own_rows.shape[1])


def build_device_shards(layout, *, quantum: int = DEVICE_SHARD_QUANTUM,
                        weights: np.ndarray | None = None,
                        with_full_indices: bool = False) -> DeviceShards:
    """Slice a mode layout into kappa rectangular rank shards.  The
    per-rank nnz cap is the largest partition rounded up to ``quantum``.
    ``weights`` (canonical COO order) and ``with_full_indices`` fill the
    valued-shard fields of the masked method."""
    kappa = layout.kappa
    in_modes = layout.input_modes()
    off = layout.part_offsets
    max_nnz = int(np.diff(off).max()) if layout.nnz else 1
    cap = max(-(-max(max_nnz, 1) // quantum) * quantum, quantum)
    W = len(in_modes)
    idx = np.zeros((kappa, cap, W), np.int32)
    vals = np.zeros((kappa, cap), np.float32)
    rows = np.full((kappa, cap), layout.num_rows - 1, np.int32)
    idx_full = (np.zeros((kappa, cap, layout.nmodes), np.int32)
                if with_full_indices else None)
    ew = np.zeros((kappa, cap), np.float32) if weights is not None else None
    w_lay = (np.asarray(weights, np.float32)[layout.perm]
             if weights is not None else None)
    for p in range(kappa):
        s, e = int(off[p]), int(off[p + 1])
        n = e - s
        idx[p, :n] = layout.indices[s:e][:, in_modes]
        vals[p, :n] = layout.values[s:e]
        rows[p, :n] = layout.rows[s:e]
        if idx_full is not None:
            idx_full[p, :n] = layout.indices[s:e]
        if ew is not None:
            ew[p, :n] = w_lay[s:e]
    row_perm = np.broadcast_to(
        layout.row_perm, (kappa,) + layout.row_perm.shape).copy()
    own_rows = gather_map = None
    if layout.scheme == Scheme.INDEX_PARTITION:
        # Scheme-1 partitions own disjoint contiguous relabeled ranges
        # [row_lo, row_hi); padding slots repeat an owned row and point at
        # the dummy destination I_d.
        counts = (layout.row_hi - layout.row_lo).astype(np.int64)
        rcap = max(int(counts.max()) if kappa else 1, 1)
        own_rows = np.zeros((kappa, rcap), np.int32)
        gather_map = np.full((kappa, rcap), layout.num_rows, np.int32)
        for p in range(kappa):
            lo, hi = int(layout.row_lo[p]), int(layout.row_hi[p])
            n = hi - lo
            own_rows[p, :n] = np.arange(lo, hi, dtype=np.int32)
            own_rows[p, n:] = lo if n else 0
            gather_map[p, :n] = layout.row_perm[lo:hi]
    return DeviceShards(
        scheme=layout.scheme, mode=layout.mode, num_rows=layout.num_rows,
        nnz_per_dev=cap, idx=idx, rows=rows, vals=vals, row_perm=row_perm,
        input_modes=tuple(in_modes), idx_full=idx_full, ew=ew,
        own_rows=own_rows, gather_map=gather_map)


def shard_fit_data(tensor, kappa: int, *,
                   quantum: int = DEVICE_SHARD_QUANTUM,
                   weights: np.ndarray | None = None):
    """Split the canonical COO across ranks for the sparse fit:
    ``(idx, vals, norm_sq)``, or with ``weights`` the weighted contract
    ``(idx, vals, ew, norm_sq)`` whose ``norm_sq`` is ``sum_e w_e x_e^2``.
    Padding is value 0 and weight 0; ``norm_sq`` is replicated per rank."""
    nnz = tensor.nnz
    per = max(-(-max(-(-nnz // kappa), 1) // quantum) * quantum, quantum)
    idx = np.zeros((kappa, per, tensor.nmodes), np.int32)
    vals = np.zeros((kappa, per), np.float32)
    ew = np.zeros((kappa, per), np.float32) if weights is not None else None
    flat_v = tensor.values.astype(np.float32)
    flat_w = (np.asarray(weights, np.float32)
              if weights is not None else None)
    for p in range(kappa):
        s = p * per
        e = min(nnz, s + per)
        if e > s:
            idx[p, : e - s] = tensor.indices[s:e]
            vals[p, : e - s] = flat_v[s:e]
            if ew is not None:
                ew[p, : e - s] = flat_w[s:e]
    if ew is not None:
        norm_sq = np.broadcast_to(
            np.float32((flat_w * flat_v) @ flat_v), (kappa,)).copy()
        return idx, vals, ew, norm_sq
    norm_sq = np.broadcast_to(
        np.float32(tensor.norm() ** 2), (kappa,)).copy()
    return idx, vals, norm_sq
