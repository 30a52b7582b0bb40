"""FROSTT ``.tns`` sparse-tensor file I/O (a copy of ``repro.data.tns``).

Format: whitespace-separated lines of N 1-based indices + value; comment
lines start with '#' (or '%').  Files ending in ``.gz`` are read and
written through gzip.  ``read_tns`` builds a host ``SparseTensor``; the
entry points move it to the card (``cpd_als(read_tns(path), rank)``).
Values are written with ``%.9g``, which round-trips float32 exactly.
"""
from __future__ import annotations

import gzip

import numpy as np

from ..core.coo import SparseTensor


def read_tns(path: str, *, dtype=np.float32) -> SparseTensor:
    opener = gzip.open if str(path).endswith(".gz") else open
    idx_rows: list[list[int]] = []
    vals: list[float] = []
    with opener(path, "rt") as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith(("#", "%")):
                continue
            parts = s.split()
            idx_rows.append([int(p) for p in parts[:-1]])
            vals.append(float(parts[-1]))
    if not idx_rows:
        raise ValueError(f"{path}: empty tensor file")
    idx = np.asarray(idx_rows, dtype=np.int64) - 1   # 1-based -> 0-based
    if idx.min() < 0:
        raise ValueError(f"{path}: index underflow (file must be 1-based)")
    shape = tuple(int(m) + 1 for m in idx.max(axis=0))
    return SparseTensor(idx.astype(np.int32), np.asarray(vals, dtype=dtype),
                        shape)


def write_tns(path: str, t: SparseTensor):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write(f"# {t.nmodes}-mode tensor, shape {t.shape}, nnz {t.nnz}\n")
        for i in range(t.nnz):
            idx = " ".join(str(int(c) + 1) for c in t.indices[i])
            f.write(f"{idx} {float(t.values[i]):.9g}\n")
