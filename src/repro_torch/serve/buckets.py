"""Shape-bucketing policy for the batched service (port of ``repro.serve.buckets``).

Requests batch only with bucket-mates: tensors of one dense shape whose
nnz rounds up to one cap, decomposed by one method.  The cap comes from
the same ``core.plan.quantize_nnz`` rule the plans use, so a bucket's
slab caps are a function of its key alone.

Padding.  ``pad_tensor`` appends zero-valued entries at coordinate
(0, ..., 0) up to the cap, ``pad_weights`` gives them observation weight
0, and ``repeat_pad`` fills a batch up to a size by repeating its last
request.  Each is an exact no-op for the results that are kept: a zero
value or a zero weight adds exactly +0.0 to every accumulation, appending
keeps every real entry's position (layout sorts are stable), and lanes
are independent.  The port's batched engine packs plain and nncp requests
unpadded under the bucket's slab cap; it pads the masked method's
(``serve.batched_engine``).  Every helper here is bitwise the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import plan as plan_mod
from ..core.coo import SparseTensor


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One (shape, nnz cap, method) class of the request stream.  The
    method is part of the key because bucket-mates share one sweep, and
    the method decides the sweep's update and (for 'masked') its mode
    data."""

    shape: tuple[int, ...]
    nnz_cap: int
    method: str = "cp"

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    @property
    def key(self) -> tuple:
        return (self.shape, self.nnz_cap, self.method)

    def padding_fraction(self, nnz: int) -> float:
        """Fraction of the bucket's nnz slots a request of ``nnz`` leaves
        to padding."""
        return (self.nnz_cap - nnz) / self.nnz_cap if self.nnz_cap else 0.0


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """nnz quantization rule, a front over ``core.plan.quantize_nnz``.

    mode 'quantum': round nnz up to the next multiple of ``quantum``.
    mode 'geometric': round nnz up to the next ``min_cap * growth^k``.
    """

    mode: str = "quantum"
    quantum: int = 128
    growth: float = 1.25
    min_cap: int = 128

    def __post_init__(self):
        if self.mode == "geometric" and self.growth <= 1.0:
            raise ValueError(f"geometric growth must be > 1, "
                             f"got {self.growth}")
        if self.quantum < 1 or self.min_cap < 1:
            raise ValueError("quantum and min_cap must be >= 1")

    @classmethod
    def for_plan(cls, tile: int = 256, **kw) -> "BucketPolicy":
        """Policy whose quantum is the plan's slab tile, so every bucket cap
        lands on a slab boundary."""
        return cls(quantum=int(tile), min_cap=int(tile), **kw)

    def nnz_cap(self, nnz: int) -> int:
        return plan_mod.quantize_nnz(
            nnz, mode=self.mode, quantum=self.quantum,
            growth=self.growth, min_cap=self.min_cap)

    def bucket_for(self, tensor: SparseTensor, method: str = "cp") -> Bucket:
        return Bucket(tuple(int(s) for s in tensor.shape),
                      self.nnz_cap(tensor.nnz), method)


def pad_weights(weights: np.ndarray, nnz_cap: int) -> np.ndarray:
    """Extend a per-entry observation-weight vector with zeros to
    ``nnz_cap``: the companion of ``pad_tensor`` for weighted methods,
    where padding must carry weight 0 (a zero value alone would say the
    tensor is observed to be zero at the origin)."""
    w = np.asarray(weights, np.float32)
    if len(w) > nnz_cap:
        raise ValueError(
            f"weight vector length {len(w)} exceeds bucket cap {nnz_cap}")
    if len(w) == nnz_cap:
        return w
    return np.concatenate([w, np.zeros(nnz_cap - len(w), np.float32)])


def repeat_pad(seq, total: int) -> list:
    """Extend a per-request sequence to ``total`` entries by repeating the
    last one: lanes are independent, so the repeated requests compute
    real but discarded results and the kept lanes are unchanged."""
    seq = list(seq)
    if not seq or total < len(seq):
        raise ValueError(f"cannot repeat-pad {len(seq)} items to {total}")
    return seq + [seq[-1]] * (total - len(seq))


def pad_tensor(tensor: SparseTensor, nnz_cap: int) -> SparseTensor:
    """Append zero-valued entries at coordinate (0, ..., 0) until
    ``nnz == nnz_cap``."""
    if tensor.nnz > nnz_cap:
        raise ValueError(
            f"tensor nnz {tensor.nnz} exceeds bucket cap {nnz_cap}")
    if tensor.nnz == nnz_cap:
        return tensor
    pad = nnz_cap - tensor.nnz
    idx = np.concatenate(
        [tensor.indices,
         np.zeros((pad, tensor.nmodes), dtype=tensor.indices.dtype)], axis=0)
    vals = np.concatenate(
        [tensor.values, np.zeros(pad, dtype=tensor.values.dtype)])
    return SparseTensor(idx, vals, tensor.shape)
