"""The benchmark's inputs, made from the run's seed.

``stand_in`` makes a sparse tensor with a configuration's exact shape and
nonzero count on the device: unique coordinates, each mode's degree of
its r-th hottest label proportional to ``(r + 1) ** -exponent``, the labels
of each mode scattered by a seeded permutation, values N(0, 1) with
``|v| >= min_abs``.  ``init_factors`` draws a call's initial factors from
``(seed, call)``.  The program sees only what these return, never a seed.
"""
from __future__ import annotations

import math

import numpy as np
import torch

OVERDRAW = 1.3      # candidates drawn per missing nonzero in one round
MAX_ROUNDS = 64


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for ``torch.Generator`` from the run's seed and tags."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _mode_labels(size: int, exponent: float, perm: torch.Tensor, n: int,
                 gen: torch.Generator) -> torch.Tensor:
    """``n`` labels of one mode: ranks drawn by the inverse of the
    power-law CDF, mapped through the mode's permutation."""
    dev = perm.device
    p = (torch.arange(size, dtype=torch.float64, device=dev) + 1.0) ** -exponent
    cdf = torch.cumsum(p / p.sum(), 0)
    u = torch.rand(n, dtype=torch.float64, device=dev, generator=gen)
    ranks = torch.clamp(torch.searchsorted(cdf, u), max=size - 1)
    return perm[ranks]


def linear_keys(coords: list[torch.Tensor], shape) -> torch.Tensor:
    key = torch.zeros_like(coords[0])
    for c, size in zip(coords, shape):
        key = key * int(size) + c
    return key


def decode_keys(keys: torch.Tensor, shape) -> torch.Tensor:
    """(nnz, N) coordinates of row-major linear keys."""
    cols = []
    rest = keys
    for size in reversed(shape):
        cols.append(rest % int(size))
        rest = rest // int(size)
    return torch.stack(cols[::-1], dim=1)


def stand_in(shape, nnz: int, seed: int, *, exponent: float = 0.5,
             min_abs: float = 1e-3, device="cuda"):
    """``(indices (nnz, N) int32, values (nnz,) float32)`` as host numpy
    arrays, coordinates unique and in row-major order."""
    shape = [int(s) for s in shape]
    if math.prod(shape) >= 1 << 62:
        raise ValueError(f"shape {shape} has too many cells for 64-bit keys")
    if nnz > math.prod(shape):
        raise ValueError("more nonzeros than cells")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(sub_seed(seed, 1))
    perms = [torch.randperm(s, device=dev, generator=gen) for s in shape]
    keys = torch.empty(0, dtype=torch.int64, device=dev)
    for _ in range(MAX_ROUNDS):
        missing = nnz - keys.numel()
        if missing <= 0:
            break
        n = int(missing * OVERDRAW) + 1024
        coords = [_mode_labels(s, exponent, perms[d], n, gen)
                  for d, s in enumerate(shape)]
        keys = torch.unique(torch.cat([keys, linear_keys(coords, shape)]))
    else:
        raise RuntimeError(f"{MAX_ROUNDS} rounds drew fewer than {nnz} "
                           f"unique coordinates")
    pick = torch.randperm(keys.numel(), device=dev, generator=gen)[:nnz]
    keys = torch.sort(keys[pick]).values
    indices = decode_keys(keys, shape).to(torch.int32)
    values = torch.randn(nnz, device=dev, generator=gen)
    values = torch.where(values.abs() < min_abs,
                         torch.full_like(values, min_abs), values)
    return indices.cpu().numpy(), values.cpu().numpy()


def init_factors(shape, rank: int, seed: int, call: int) -> list[np.ndarray]:
    """Call ``call``'s initial factors: N(0, 1), float32, one per mode."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 2, int(call)])
    return [rng.standard_normal((int(s), rank), dtype=np.float32)
            for s in shape]
