"""Mode-specific tensor layouts (paper §III), host numpy.

For every mode d the tensor gets a dedicated copy whose nonzeros are
ordered for mode-d-as-output execution:

  * scheme 1: sorted by (owning partition, output row), so each
    partition's slice is contiguous and row-sorted;
  * scheme 2: sorted by output row, split into equal-nnz slices.

Output rows are *relabeled* so each scheme-1 partition owns a contiguous
row range.  Kernels compute in relabeled space and the MTTKRP front door
scatters rows back through ``row_perm``.  The arrays are bitwise those of
``repro.core.layout``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .coo import SparseTensor
from .load_balance import Partitioning, Scheme, partition_mode


@dataclasses.dataclass(frozen=True)
class ModeLayout:
    """Mode-d copy of the tensor, execution-ready.

    Attributes:
      mode: output mode d.
      shape: dense tensor shape.
      scheme: load-balancing scheme used.
      kappa: number of partitions.
      indices: (nnz, N) int32 COO indices in execution order (original
        labels; ``rows`` holds the relabeled output row).
      rows: (nnz,) int32 relabeled output row per nonzero, sorted.
      values: (nnz,) values in execution order.
      perm: (nnz,) int64 permutation from the canonical COO order.
      part_offsets: (kappa+1,) int64 nnz slice per partition.
      row_perm: (I_d,) int32 relabeled row -> original row id.
      row_lo/row_hi: (kappa,) int32 relabeled row range per partition.
      row_ptr: (I_d+1,) int64 CSR offsets of each relabeled row.
    """

    mode: int
    shape: tuple[int, ...]
    scheme: Scheme
    kappa: int
    indices: np.ndarray
    rows: np.ndarray
    values: np.ndarray
    perm: np.ndarray
    part_offsets: np.ndarray
    row_perm: np.ndarray
    row_lo: np.ndarray
    row_hi: np.ndarray
    row_ptr: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    @property
    def num_rows(self) -> int:
        return int(self.shape[self.mode])

    def input_modes(self) -> list[int]:
        return [w for w in range(self.nmodes) if w != self.mode]


def build_mode_layout(
    tensor: SparseTensor,
    mode: int,
    kappa: int,
    *,
    scheme: Scheme | None = None,
    assignment: str = "greedy",
) -> ModeLayout:
    """Construct the mode-``mode`` copy partitioned across ``kappa`` units
    (scheme None: the paper's adaptive threshold rule)."""
    part: Partitioning = partition_mode(
        tensor, mode, kappa, scheme=scheme, assignment=assignment
    )
    I_d = tensor.shape[mode]
    idx_perm = tensor.indices[part.perm]
    val_perm = tensor.values[part.perm]

    if part.scheme == Scheme.INDEX_PARTITION:
        # Relabel rows: sort rows by (partition, original id); rank = new id.
        row_order = np.lexsort((np.arange(I_d), part.vertex_part))
        row_perm = row_order.astype(np.int32)          # new -> old
        row_rank = np.empty(I_d, dtype=np.int32)       # old -> new
        row_rank[row_order] = np.arange(I_d, dtype=np.int32)
        rows = row_rank[idx_perm[:, mode]]
        counts = np.bincount(part.vertex_part, minlength=kappa)
        row_hi = np.cumsum(counts).astype(np.int32)
        row_lo = (row_hi - counts).astype(np.int32)
    else:
        row_perm = np.arange(I_d, dtype=np.int32)
        rows = idx_perm[:, mode].astype(np.int32)
        row_lo = np.zeros(kappa, dtype=np.int32)
        row_hi = np.full(kappa, I_d, dtype=np.int32)

    # rows are globally sorted: scheme 2 sorts by row; scheme 1 sorts by
    # (partition, row) and partitions own increasing relabeled ranges.
    row_ptr = np.zeros(I_d + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=I_d), out=row_ptr[1:])

    return ModeLayout(
        mode=mode,
        shape=tensor.shape,
        scheme=part.scheme,
        kappa=kappa,
        indices=idx_perm.astype(np.int32),
        rows=rows.astype(np.int32),
        values=val_perm,
        perm=part.perm,
        part_offsets=part.offsets,
        row_perm=row_perm,
        row_lo=row_lo,
        row_hi=row_hi,
        row_ptr=row_ptr,
    )


def build_all_mode_layouts(
    tensor: SparseTensor,
    kappa: int,
    *,
    scheme: Scheme | None = None,
    assignment: str = "greedy",
) -> list[ModeLayout]:
    """The paper's full mode-specific format: one execution-ready copy per mode."""
    return [
        build_mode_layout(tensor, d, kappa, scheme=scheme, assignment=assignment)
        for d in range(tensor.nmodes)
    ]
