"""Adaptive load balancing (paper §III-B).

Two schemes, chosen adaptively per output mode against kappa partitions:

  Scheme 1 (I_d >= kappa): distribute output-mode *indices* among
    partitions so each partition owns a disjoint set of output rows.
    Vertices are ordered by hypergraph degree and assigned greedily to the
    least-loaded partition (LPT, 4/3 bound), or cyclically as the paper
    describes.
  Scheme 2 (I_d < kappa): distribute the *nonzeros* equally: sort
    hyperedges by output vertex id and split into kappa equal chunks.

Partitioning is one-time preprocessing per tensor per mode.  The work
over the nonzeros (each vertex's degree, each nonzero's sort key and the
stable sort that orders them) runs as torch operations on the device the
mode's index column lies on; the work over the vertices (the greedy heap,
the offsets) runs on the host.  The arrays are bitwise those of
``repro.core.load_balance``.  ``scheme_cost`` /
``choose_scheme_cost_based`` price both schemes from the partitioning
statistics (``layout`` ``policy="cost"``); ``balance_bound_holds`` checks
a partitioning against Graham's 4/3 bound.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq

import numpy as np
import torch

from ..obs import trace as obs_trace
from .coo import SparseTensor


class Scheme(enum.Enum):
    INDEX_PARTITION = 1  # paper's Load Balancing Scheme 1
    NNZ_PARTITION = 2    # paper's Load Balancing Scheme 2


@dataclasses.dataclass(frozen=True)
class Partitioning:
    """Result of partitioning one output mode across kappa partitions.

    Attributes:
      scheme: which load-balancing scheme was used.
      mode: the output mode d.
      kappa: number of partitions.
      order: (nnz,) int64 tensor, on the device the partition was computed
        on, ordering the COO nnz so partition p's nonzeros are
        ``order[offsets[p]:offsets[p+1]]``; ``perm`` is its host copy.
      offsets: (kappa+1,) int64 nnz boundaries per partition.
      vertex_part: (I_d,) int32 partition id per output index (scheme 1),
        else None (scheme 2 shares all vertices).
      degrees: (I_d,) int64 nonzeros per output index.
    """

    scheme: Scheme
    mode: int
    kappa: int
    order: torch.Tensor
    offsets: np.ndarray
    vertex_part: np.ndarray | None
    degrees: np.ndarray

    @property
    def perm(self) -> np.ndarray:
        """(nnz,) int64 host copy of ``order``."""
        return self.order.cpu().numpy()

    @property
    def loads(self) -> np.ndarray:
        return np.diff(self.offsets)

    def imbalance(self) -> float:
        """max partition load / mean load (1.0 == perfect)."""
        loads = self.loads
        mean = loads.mean() if len(loads) else 0.0
        return float(loads.max() / mean) if mean else 1.0


def choose_scheme(num_indices: int, kappa: int) -> Scheme:
    """The paper's adaptive rule: indices >= kappa -> scheme 1 else scheme 2."""
    return Scheme.INDEX_PARTITION if num_indices >= kappa else Scheme.NNZ_PARTITION


# -- beyond the paper: cost-model-driven scheme selection -------------------
#
# The paper's threshold rule mispicks near the I_d ~ kappa boundary: a mode
# with I_d = 100 on kappa = 82 partitions is "scheme 1" by the rule, but its
# vertex partitioning is lumpy (1-2 vertices per partition -> makespan ~2x
# mean), while scheme 2's balanced nnz split plus one small reduction is
# cheaper.  Pricing both schemes from the actual partitioning statistics
# and taking the argmin fixes those cells.  Copied from the reference with
# its float arithmetic in the same order, so the costs are equal as floats.


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Update-cost model.  The defaults are the reference's RTX-3090-class
    values (the paper's platform), neither a TPU's nor an H100's; they are
    kept for parity with the reference.  A profile of the card in use is
    measured, not written here (``chip_smoke.py``'s plan phase measures
    ``bw`` and ``atomic_tput`` on the H100)."""

    bw: float = 936.2e9           # global-memory B/s
    atomic_tput: float = 1.2e11   # shared-output update ops/s
    local_factor: float = 0.1     # partition-private update discount
    rank: int = 32
    float_bytes: int = 4


def scheme_cost(
    tensor: SparseTensor, mode: int, kappa: int, scheme: Scheme,
    *, profile: DeviceProfile = DeviceProfile(), assignment: str = "greedy",
) -> float:
    """Modeled execution time of one MTTKRP along ``mode`` under ``scheme``
    (partitions the mode on the host)."""
    part = partition_mode(tensor, mode, kappa, scheme=scheme,
                          assignment=assignment)
    N, nnz = tensor.nmodes, tensor.nnz
    R, F = profile.rank, profile.float_bytes
    bytes_moved = nnz * (4 * N + 4) + nnz * (N - 1) * R * F \
        + tensor.shape[mode] * R * F
    traffic = bytes_moved / profile.bw * part.imbalance()
    updates = nnz * R / profile.atomic_tput
    if scheme == Scheme.INDEX_PARTITION:
        updates *= profile.local_factor
    return traffic + updates


def choose_scheme_cost_based(
    tensor: SparseTensor, mode: int, kappa: int,
    *, profile: DeviceProfile = DeviceProfile(), assignment: str = "greedy",
) -> Scheme:
    """The cheaper scheme by ``scheme_cost`` (scheme 1 on a tie)."""
    c1 = scheme_cost(tensor, mode, kappa, Scheme.INDEX_PARTITION,
                     profile=profile, assignment=assignment)
    c2 = scheme_cost(tensor, mode, kappa, Scheme.NNZ_PARTITION,
                     profile=profile, assignment=assignment)
    return Scheme.INDEX_PARTITION if c1 <= c2 else Scheme.NNZ_PARTITION


def partition_mode(
    tensor: SparseTensor,
    mode: int,
    kappa: int,
    *,
    scheme: Scheme | None = None,
    assignment: str = "greedy",
    column: torch.Tensor | None = None,
) -> Partitioning:
    """Partition the nonzeros of ``tensor`` for output ``mode`` into kappa parts.

    assignment: 'greedy' (LPT least-loaded, 4/3 bound) or 'cyclic' (the
      paper's round-robin over the degree-ordered vertex list).
    column: the mode's (nnz,) index column as a tensor; the nonzeros are
      ordered on its device (default: the host tensor's, on the CPU).

    The ordering runs in a ``plan.sort`` span (``mode``) that ends once
    the device has finished it.
    """
    if kappa < 1:
        raise ValueError("kappa must be >= 1")
    I_d = tensor.shape[mode]
    if scheme is None:
        scheme = choose_scheme(I_d, kappa)
    if column is None:
        column = torch.from_numpy(tensor.indices[:, mode])
    with obs_trace.span("plan.sort", cat="plan", mode=mode):
        degrees = torch.bincount(column, minlength=I_d).cpu().numpy()
        if scheme == Scheme.INDEX_PARTITION:
            vertex_part = _assign_vertices(degrees, kappa, assignment)
            if kappa == 1:
                key = column
            else:
                # Order nnz by (partition, output row): each partition's
                # slice is already row-sorted, so the segmented reduction
                # needs no sort.  One stable sort of the combined key is
                # ``np.lexsort((idx_d, nnz_part))``.
                part_t = torch.as_tensor(vertex_part, device=column.device)
                key = torch.index_select(part_t, 0, column)
                if kappa * I_d >= 2 ** 31:
                    key = key.long()
                key = key * I_d + column
            order = torch.sort(key, stable=True).indices
            del key
            counts = np.bincount(vertex_part, weights=degrees,
                                 minlength=kappa).astype(np.int64)
        else:
            # Scheme 2: order hyperedges by output vertex id, split equally.
            vertex_part = None
            order = torch.sort(column, stable=True).indices
            base, rem = divmod(tensor.nnz, kappa)
            counts = np.full(kappa, base, dtype=np.int64)
            counts[:rem] += 1
        if order.device.type == "cuda":
            torch.cuda.synchronize(order.device)
    offsets = np.zeros(kappa + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return Partitioning(scheme, mode, kappa, order, offsets, vertex_part,
                        degrees)


def _assign_vertices(degrees: np.ndarray, kappa: int,
                     assignment: str) -> np.ndarray:
    """(I_d,) int32 partition of each output index, heavy vertices first."""
    if assignment not in ("greedy", "cyclic"):
        raise ValueError(f"unknown assignment {assignment!r}")
    I_d = len(degrees)
    if kappa == 1:      # what either assignment gives on one partition
        return np.zeros(I_d, dtype=np.int32)
    order = np.argsort(-degrees, kind="stable")  # heavy first
    vertex_part = np.empty(I_d, dtype=np.int32)
    if assignment == "cyclic":
        vertex_part[order] = np.arange(I_d, dtype=np.int32) % kappa
        return vertex_part
    heap = [(0, p) for p in range(kappa)]
    heapq.heapify(heap)
    for v in order:
        load, p = heapq.heappop(heap)
        vertex_part[v] = p
        heapq.heappush(heap, (load + int(degrees[v]), p))
    return vertex_part


def balance_bound_holds(part: Partitioning, tensor: SparseTensor) -> bool:
    """Check Graham's 4/3 bound for greedy scheme-1 partitionings.

    The guarantee is max_load <= opt * 4/3 where opt >= max(mean_load,
    max_single_vertex_degree) -- the latter because a vertex is atomic.
    A scheme-2 split is held to its equal share, ceil(nnz / kappa).
    """
    loads = part.loads.astype(np.float64)
    if part.scheme == Scheme.NNZ_PARTITION:
        return bool(loads.max() <= np.ceil(tensor.nnz / part.kappa))
    degrees = tensor.mode_degrees(part.mode).astype(np.float64)
    opt_lb = max(loads.sum() / part.kappa, degrees.max() if len(degrees) else 0.0)
    return bool(loads.max() <= (4.0 / 3.0) * opt_lb + 1e-9)
