"""COO sparse-tensor container + synthetic FROSTT-like generators.

The paper (Wijeratne et al., 2025) stores the input tensor in COOrdinate
format: each nonzero is a tuple <(c_0..c_{N-1}), val>.  ``SparseTensor``
is the host-side container; mode-specific layouts are built from it by
``repro_torch.core.layout``.

Host numpy only, and a copy of ``repro.core.coo``: for the same seed the
generators make bitwise the same arrays as the JAX package's (same RNG
call order), which is what lets the port be held against it.

All index arrays are int32 (the paper's "small tensor" regime guarantees
every mode dimension < 2^31) and values default to float32, matching the
paper's fp32 evaluation.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """An N-mode sparse tensor in COO format (host-resident numpy).

    Attributes:
      indices: (nnz, N) int32 — per-mode coordinates of each nonzero.
      values:  (nnz,) float — nonzero values.
      shape:   tuple of N ints — dense dimensions I_0..I_{N-1}.
    """

    indices: np.ndarray
    values: np.ndarray
    shape: tuple[int, ...]

    def __post_init__(self):
        if self.indices.ndim != 2:
            raise ValueError(f"indices must be (nnz, N), got {self.indices.shape}")
        if self.values.ndim != 1 or self.values.shape[0] != self.indices.shape[0]:
            raise ValueError("values must be (nnz,) aligned with indices")
        if self.indices.shape[1] != len(self.shape):
            raise ValueError(
                f"indices has {self.indices.shape[1]} modes, shape has {len(self.shape)}"
            )
        for d, I in enumerate(self.shape):
            if self.nnz and int(self.indices[:, d].max()) >= I:
                raise ValueError(f"mode-{d} index out of range (I_{d}={I})")

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    @property
    def density(self) -> float:
        dense = float(np.prod([float(s) for s in self.shape]))
        return self.nnz / dense if dense else 0.0

    def mode_degrees(self, d: int) -> np.ndarray:
        """Hyperedge count incident on each mode-d vertex (hypergraph degree)."""
        return np.bincount(self.indices[:, d], minlength=self.shape[d]).astype(np.int64)

    def to_dense(self) -> np.ndarray:
        """Densify — only for tiny test tensors."""
        if float(np.prod([float(s) for s in self.shape])) > 5e7:
            raise ValueError("refusing to densify a large tensor")
        out = np.zeros(self.shape, dtype=self.values.dtype)
        # np.add.at handles duplicate coordinates by accumulation, matching
        # the semantics of MTTKRP over a COO list with possible duplicates.
        np.add.at(out, tuple(self.indices.T), self.values)
        return out

    def matricize(self, d: int) -> np.ndarray:
        """Mode-d matricization X_(d) as a dense (I_d, prod(I_w, w!=d)) matrix.

        Column ordering follows Kolda & Bader: the mode-w indices (w != d)
        sweep with the *lowest* remaining mode varying fastest.
        """
        dense = self.to_dense()
        order = [d] + [w for w in range(self.nmodes) if w != d]
        return np.transpose(dense, order).reshape(self.shape[d], -1)

    def deduplicate(self) -> "SparseTensor":
        """Sum values at duplicate coordinates (canonical COO)."""
        keys = _linearize(self.indices, self.shape)
        order = np.argsort(keys, kind="stable")
        keys_s = keys[order]
        uniq_mask = np.empty(len(keys_s), dtype=bool)
        uniq_mask[:1] = True
        uniq_mask[1:] = keys_s[1:] != keys_s[:-1]
        group = np.cumsum(uniq_mask) - 1
        vals = np.zeros(int(group[-1]) + 1 if len(group) else 0, dtype=self.values.dtype)
        np.add.at(vals, group, self.values[order])
        idx = self.indices[order][uniq_mask]
        return SparseTensor(idx, vals, self.shape)

    def permuted(self, perm: np.ndarray) -> "SparseTensor":
        return SparseTensor(self.indices[perm], self.values[perm], self.shape)

    def norm(self) -> float:
        return float(np.linalg.norm(self.values))


def _linearize(indices: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Row-major linearized int64 keys for COO coordinates."""
    key = np.zeros(indices.shape[0], dtype=np.int64)
    for d, I in enumerate(shape):
        key = key * int(I) + indices[:, d].astype(np.int64)
    return key


# ---------------------------------------------------------------------------
# Synthetic generators
# ---------------------------------------------------------------------------


def random_sparse(
    shape: Sequence[int],
    nnz: int,
    *,
    seed: int = 0,
    distribution: str = "uniform",
    zipf_a: float = 1.3,
    dtype=np.float32,
) -> SparseTensor:
    """Random sparse tensor with `nnz` unique coordinates.

    distribution:
      'uniform'  — coordinates uniform per mode (unstructured).
      'zipf'     — per-mode Zipf-distributed indices (power-law hot rows),
                   which is what real FROSTT tensors look like and what makes
                   load balancing non-trivial (paper §III-B).
    """
    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in shape)
    n = len(shape)
    # Oversample then dedupe to reach the requested unique nnz.
    want = nnz
    idx_parts = []
    attempts = 0
    seen: np.ndarray | None = None
    while True:
        m = max(int(want * 1.3) + 16, 64)
        cols = []
        for d, I in enumerate(shape):
            if distribution == "uniform" or I <= 2:
                c = rng.integers(0, I, size=m, dtype=np.int64)
            elif distribution == "zipf":
                z = rng.zipf(zipf_a, size=m).astype(np.int64) - 1
                c = z % I
            elif distribution == "powerlaw":
                # fiber-length skew like real FROSTT tensors: degree of the
                # r-th hottest index ~ (r+1)^-0.5 (hottest ~10-45x mean at
                # I=2048 but below nnz/kappa, matching real FROSTT fiber skew)
                p = (np.arange(I, dtype=np.float64) + 1.0) ** -0.5
                p /= p.sum()
                c = rng.choice(I, size=m, p=p)
            else:
                raise ValueError(f"unknown distribution {distribution!r}")
            cols.append(c)
        cand = np.stack(cols, axis=1)
        keys = _linearize(cand.astype(np.int32), shape)
        if seen is None:
            pool_keys = keys
            pool = cand
        else:
            pool_keys = np.concatenate([seen_keys, keys])  # noqa: F821
            pool = np.concatenate([seen, cand], axis=0)
        _, first = np.unique(pool_keys, return_index=True)
        first.sort()
        pool = pool[first]
        pool_keys = pool_keys[first]
        if len(pool) >= nnz or attempts > 20:
            idx = pool[:nnz]
            break
        seen, seen_keys = pool, pool_keys
        want = nnz - len(pool)
        attempts += 1
    vals = rng.standard_normal(len(idx)).astype(dtype)
    # Avoid exact zeros so nnz stays meaningful.
    vals = np.where(np.abs(vals) < 1e-3, 1e-3, vals).astype(dtype)
    order = np.lexsort(tuple(idx[:, d] for d in reversed(range(n))))
    return SparseTensor(idx[order].astype(np.int32), vals[order], shape)


def low_rank_sparse(
    shape: Sequence[int],
    nnz: int,
    rank: int,
    *,
    seed: int = 0,
    noise: float = 0.0,
    dtype=np.float32,
) -> tuple[SparseTensor, list[np.ndarray]]:
    """Sparse sampling of an exactly-rank-R CP tensor (for CPD recovery tests).

    Returns (tensor, true_factors). Values are the CP model evaluated at the
    sampled coordinates plus optional Gaussian noise.
    """
    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in shape)
    factors = [rng.standard_normal((I, rank)).astype(dtype) for I in shape]
    base = random_sparse(shape, nnz, seed=seed + 1, distribution="uniform", dtype=dtype)
    vals = np.ones(base.nnz, dtype=np.float64)
    acc = np.ones((base.nnz, rank), dtype=np.float64)
    for d, F in enumerate(factors):
        acc *= F[base.indices[:, d]].astype(np.float64)
    vals = acc.sum(axis=1)
    if noise:
        vals = vals + noise * rng.standard_normal(base.nnz)
    return SparseTensor(base.indices, vals.astype(dtype), shape), factors


# FROSTT Table III shapes.  ``scale`` shrinks nnz (and mode sizes beyond a
# cap) so CPU CI remains fast while preserving the shape *ratios* that drive
# the adaptive load-balancer decisions (e.g. Chicago/Uber/Nips have modes
# with I_d < kappa, Enron/Nell have I_d >> kappa).
FROSTT_SHAPES: dict[str, tuple[tuple[int, ...], int]] = {
    "chicago": ((6_186, 24, 77, 32), 5_330_673),
    "enron": ((6_066, 5_699, 244_268, 1_176), 54_202_099),
    "nell-1": ((2_902_330, 2_143_368, 25_495_389), 143_599_552),
    "nips": ((2_482, 2_862, 14_036, 17), 3_101_609),
    "uber": ((183, 24, 1_140, 1_717), 3_309_490),
    "vast": ((165_427, 11_374, 2, 100, 89), 26_021_945),
}


def frostt_like(name: str, *, scale: float = 1.0, seed: int = 0) -> SparseTensor:
    """Synthetic stand-in for a FROSTT tensor (offline container: no download).

    Keeps the exact mode count and dimension *ratios* of Table III.  With
    ``scale < 1`` the nnz count shrinks by ``scale`` and any mode dimension
    larger than ``nnz_scaled`` is clamped (a mode can't have more useful
    indices than nonzeros).  Zipf-distributed indices reproduce the skewed
    fiber-length histograms of the real datasets.
    """
    key = name.lower()
    if key not in FROSTT_SHAPES:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(FROSTT_SHAPES)}")
    shape, nnz = FROSTT_SHAPES[key]
    nnz_s = max(int(nnz * scale), 128)
    # Small mode dims are kept EXACT — they decide which load-balancing
    # scheme the adaptive rule picks (the paper's central structure);
    # only large dims shrink, and never below what nnz can populate.
    shape_s = tuple(
        I if I <= 2048 else min(max(2048, int(I * scale * 4)), nnz_s)
        for I in shape
    )
    return random_sparse(shape_s, nnz_s, seed=seed, distribution="powerlaw")
