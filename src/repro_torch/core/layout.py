"""Mode-specific tensor layouts (paper §III).

For every mode d the tensor gets a dedicated copy whose nonzeros are
ordered for mode-d-as-output execution:

  * scheme 1: sorted by (owning partition, output row), so each
    partition's slice is contiguous and row-sorted;
  * scheme 2: sorted by output row, split into equal-nnz slices.

Output rows are *relabeled* so each scheme-1 partition owns a contiguous
row range.  Kernels compute in relabeled space and the MTTKRP front door
scatters rows back through ``row_perm``.

A layout is built where its index column lies: the ordering of the
nonzeros (``load_balance.partition_mode``) is a stable sort on that
device, kept on the host as ``order`` until packing uploads it; the
relabeling and ``row_ptr`` are per-row host arrays.  The per-nonzero host
arrays (``perm``, ``indices``, ``rows``, ``values``) are gathered from the
host tensor the first time a host consumer reads them.  Every array is
bitwise that of ``repro.core.layout``, under either scheme policy
('threshold', the paper's rule, or 'cost').  ``format_memory_report`` is
the fig-5 memory accounting of the copies.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .coo import SparseTensor
from .load_balance import (Partitioning, Scheme, choose_scheme_cost_based,
                           partition_mode)


@dataclasses.dataclass(eq=False)
class ModeLayout:
    """Mode-d copy of the tensor, execution-ready.

    Attributes:
      mode: output mode d.
      shape: dense tensor shape.
      scheme: load-balancing scheme used.
      kappa: number of partitions.
      tensor: the host tensor the copy orders.
      order: (nnz,) host tensor, int32 below 2**31 nonzeros else int64:
        the canonical COO position of each execution-order entry.
      part_offsets: (kappa+1,) int64 nnz slice per partition.
      row_perm: (I_d,) int32 relabeled row -> original row id.
      row_lo/row_hi: (kappa,) int32 relabeled row range per partition.
      row_ptr: (I_d+1,) int64 CSR offsets of each relabeled row.

    Host arrays gathered on first read and kept:
      perm: (nnz,) int64 permutation from the canonical COO order.
      indices: (nnz, N) int32 COO indices in execution order (original
        labels; ``rows`` holds the relabeled output row).
      rows: (nnz,) int32 relabeled output row per nonzero, sorted.
      values: (nnz,) values in execution order.
    """

    mode: int
    shape: tuple[int, ...]
    scheme: Scheme
    kappa: int
    tensor: SparseTensor
    order: torch.Tensor
    part_offsets: np.ndarray
    row_perm: np.ndarray
    row_lo: np.ndarray
    row_hi: np.ndarray
    row_ptr: np.ndarray
    _host: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def nnz(self) -> int:
        return int(self.order.shape[0])

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    @property
    def num_rows(self) -> int:
        return int(self.shape[self.mode])

    def input_modes(self) -> list[int]:
        return [w for w in range(self.nmodes) if w != self.mode]

    def _cached(self, name: str, make):
        if name not in self._host:
            self._host[name] = make()
        return self._host[name]

    @property
    def perm(self) -> np.ndarray:
        return self._cached("perm",
                            lambda: self.order.numpy().astype(np.int64))

    @property
    def indices(self) -> np.ndarray:
        return self._cached(
            "indices",
            lambda: self.tensor.indices[self.perm].astype(np.int32))

    @property
    def values(self) -> np.ndarray:
        return self._cached("values", lambda: self.tensor.values[self.perm])

    @property
    def rows(self) -> np.ndarray:
        # Sorted, so each relabeled row repeated by its count.
        return self._cached("rows", lambda: np.repeat(
            np.arange(self.num_rows, dtype=np.int32), np.diff(self.row_ptr)))

    def nbytes(self) -> int:
        """Host bytes of the copy: indices, rows and values (the paper's
        §III-C per-nnz model, rounded up to the int32/float32 arrays
        stored)."""
        return self.nnz * (4 * self.nmodes + 4
                           + self.tensor.values.dtype.itemsize)


def coo_columns(tensor: SparseTensor, device) -> torch.Tensor:
    """(N, nnz) int32 index columns of ``tensor`` on ``device`` (on the CPU
    a view of the host array)."""
    idx = torch.from_numpy(np.asarray(tensor.indices, dtype=np.int32))
    if torch.device(device).type == "cpu":
        return idx.T
    return idx.to(device).T.contiguous()


def build_mode_layout(
    tensor: SparseTensor,
    mode: int,
    kappa: int,
    *,
    scheme: Scheme | None = None,
    assignment: str = "greedy",
    policy: str = "threshold",
    columns: torch.Tensor | None = None,
) -> ModeLayout:
    """Construct the mode-``mode`` copy partitioned across ``kappa`` units.

    policy (when scheme is None): 'threshold' = the paper's adaptive rule;
    'cost' = the cost-model argmin (``load_balance.choose_scheme_cost_based``
    under its default profile).
    columns: ``coo_columns(tensor, device)``: the copy is sorted on their
      device (default: the CPU).
    """
    if scheme is None and policy == "cost":
        scheme = choose_scheme_cost_based(tensor, mode, kappa,
                                          assignment=assignment)
    if columns is None:
        columns = coo_columns(tensor, "cpu")
    part: Partitioning = partition_mode(
        tensor, mode, kappa, scheme=scheme, assignment=assignment,
        column=columns[mode])
    I_d = tensor.shape[mode]

    if part.scheme == Scheme.INDEX_PARTITION:
        # Relabel rows: sort rows by (partition, original id); rank = new id.
        row_order = np.lexsort((np.arange(I_d), part.vertex_part))
        row_perm = row_order.astype(np.int32)          # new -> old
        counts = np.bincount(part.vertex_part, minlength=kappa)
        row_hi = np.cumsum(counts).astype(np.int32)
        row_lo = (row_hi - counts).astype(np.int32)
    else:
        row_perm = np.arange(I_d, dtype=np.int32)
        row_lo = np.zeros(kappa, dtype=np.int32)
        row_hi = np.full(kappa, I_d, dtype=np.int32)

    # Execution order is sorted by relabeled row (scheme 2 by row; scheme
    # 1 by (partition, row), partitions owning increasing relabeled
    # ranges), so a relabeled row's count is its original row's degree.
    row_ptr = np.zeros(I_d + 1, dtype=np.int64)
    np.cumsum(part.degrees[row_perm], out=row_ptr[1:])

    order = part.order
    if tensor.nnz < 2 ** 31:
        order = order.to(torch.int32)
    # On the host between the sort and the packing: the device then holds
    # one copy's ordering at a time.
    order = order.cpu()
    return ModeLayout(
        mode=mode,
        shape=tensor.shape,
        scheme=part.scheme,
        kappa=kappa,
        tensor=tensor,
        order=order,
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
    policy: str = "threshold",
    columns: torch.Tensor | None = None,
) -> list[ModeLayout]:
    """The paper's full mode-specific format: one execution-ready copy per
    mode, each sorted on the device of ``columns`` (default: the CPU)."""
    if columns is None:
        columns = coo_columns(tensor, "cpu")
    return [
        build_mode_layout(tensor, d, kappa, scheme=scheme,
                          assignment=assignment, policy=policy,
                          columns=columns)
        for d in range(tensor.nmodes)
    ]


def format_memory_report(tensor: SparseTensor, layouts: list[ModeLayout]) -> dict:
    """Fig-5-style memory accounting: N copies + factor matrices at the
    reference's fixed R = 32 (float32), for parity with it.  The copies
    count the int32 indices and rows and the values of every layout."""
    R = 32
    copies = sum(l.nbytes() for l in layouts)
    factors = sum(int(I) * R * 4 for I in tensor.shape)
    # Paper's analytic model: |x|_bits = sum_h log2(I_h) + 32 bits per nnz.
    analytic_bits_per_nnz = sum(np.log2(max(2, I)) for I in tensor.shape) + 32
    analytic = int(tensor.nmodes * tensor.nnz * analytic_bits_per_nnz / 8)
    return {
        "nnz": tensor.nnz,
        "copies_bytes": int(copies),
        "factors_bytes": int(factors),
        "total_bytes": int(copies + factors),
        "analytic_copies_bytes": analytic,
    }
