"""Adaptive load balancing (paper §III-B), host numpy.

Two schemes, chosen adaptively per output mode against kappa partitions:

  Scheme 1 (I_d >= kappa): distribute output-mode *indices* among
    partitions so each partition owns a disjoint set of output rows.
    Vertices are ordered by hypergraph degree and assigned greedily to the
    least-loaded partition (LPT, 4/3 bound), or cyclically as the paper
    describes.
  Scheme 2 (I_d < kappa): distribute the *nonzeros* equally: sort
    hyperedges by output vertex id and split into kappa equal chunks.

Partitioning is one-time preprocessing per tensor per mode.  The arrays
are bitwise those of ``repro.core.load_balance``.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq

import numpy as np

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
      perm: (nnz,) int64 ordering of the COO nnz so partition p's nonzeros
        are ``perm[offsets[p]:offsets[p+1]]``.
      offsets: (kappa+1,) int64 nnz boundaries per partition.
      vertex_part: (I_d,) int32 partition id per output index (scheme 1),
        else None (scheme 2 shares all vertices).
    """

    scheme: Scheme
    mode: int
    kappa: int
    perm: np.ndarray
    offsets: np.ndarray
    vertex_part: np.ndarray | None

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


def partition_mode(
    tensor: SparseTensor,
    mode: int,
    kappa: int,
    *,
    scheme: Scheme | None = None,
    assignment: str = "greedy",
) -> Partitioning:
    """Partition the nonzeros of ``tensor`` for output ``mode`` into kappa parts.

    assignment: 'greedy' (LPT least-loaded, 4/3 bound) or 'cyclic' (the
      paper's round-robin over the degree-ordered vertex list).
    """
    if kappa < 1:
        raise ValueError("kappa must be >= 1")
    I_d = tensor.shape[mode]
    if scheme is None:
        scheme = choose_scheme(I_d, kappa)
    idx_d = tensor.indices[:, mode].astype(np.int64)

    if scheme == Scheme.INDEX_PARTITION:
        degrees = np.bincount(idx_d, minlength=I_d)
        order = np.argsort(-degrees, kind="stable")  # heavy first
        vertex_part = np.empty(I_d, dtype=np.int32)
        if assignment == "cyclic":
            vertex_part[order] = np.arange(I_d, dtype=np.int32) % kappa
        elif assignment == "greedy":
            heap = [(0, p) for p in range(kappa)]
            heapq.heapify(heap)
            for v in order:
                load, p = heapq.heappop(heap)
                vertex_part[v] = p
                heapq.heappush(heap, (load + int(degrees[v]), p))
        else:
            raise ValueError(f"unknown assignment {assignment!r}")
        nnz_part = vertex_part[idx_d]
        # Order nnz by (partition, output row): each partition's slice is
        # already row-sorted, so the segmented reduction needs no sort.
        perm = np.lexsort((idx_d, nnz_part))
        counts = np.bincount(nnz_part, minlength=kappa)
        offsets = np.zeros(kappa + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return Partitioning(scheme, mode, kappa, perm, offsets, vertex_part)

    # Scheme 2: order hyperedges by output vertex id, split equally.
    perm = np.argsort(idx_d, kind="stable")
    nnz = tensor.nnz
    base, rem = divmod(nnz, kappa)
    counts = np.full(kappa, base, dtype=np.int64)
    counts[:rem] += 1
    offsets = np.zeros(kappa + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return Partitioning(scheme, mode, kappa, perm, offsets, None)
