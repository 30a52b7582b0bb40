"""Quickstart on the PyTorch/CUDA port: decompose a small sparse tensor
with CPD-ALS.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

The default device is the card; ``--device cpu`` runs the kernel's plain
PyTorch version instead.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import cpd_als, make_plan, mttkrp, random_sparse

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
dev = parser.parse_args().device

# 1. a synthetic 3-mode sparse tensor (power-law index skew, like FROSTT)
t = random_sparse((500, 120, 40), 20_000, seed=0, distribution="powerlaw")
print(f"tensor {t.shape}, nnz={t.nnz}, density={t.density:.2e}")

# 2. the paper's preprocessing: one mode-specific layout per mode,
#    adaptive load balancing across kappa partitions
plan = make_plan(t, kappa=82, device=dev)
for d, lay in enumerate(plan.layouts):
    print(f"  mode {d}: scheme={lay.scheme.name} "
          f"(I_d={t.shape[d]}, partitions={lay.kappa})")

# 3. one MTTKRP along mode 0 (the bottleneck kernel: the slab kernel on
#    the card)
R = 16
factors = [torch.as_tensor(np.random.default_rng(d).standard_normal((I, R))
                           .astype(np.float32), device=plan.device)
           for d, I in enumerate(t.shape)]
M = mttkrp(plan, factors, mode=0)
print(f"MTTKRP mode 0 -> {tuple(M.shape)}")

# 4. full CPD-ALS -- the default engine is the device-resident fused sweep:
#    MTTKRP, gram updates, solve, normalization and the sparse fit stay on
#    the device; the host syncs only at the convergence check.
res = cpd_als(t, rank=R, plan=plan, n_iters=10, check_every=2, verbose=True,
              device=dev)
print(f"final fit {res.fits[-1]:.4f} in {res.iters} iters "
      f"[{res.engine} engine, {res.host_syncs} host syncs] "
      f"in {res.total_seconds:.2f}s")

# 5. the per-mode host loop survives for comparison
res_h = cpd_als(t, rank=R, plan=plan, n_iters=10, engine="host", device=dev)
print(f"host engine: {res_h.host_syncs} host syncs, "
      f"MTTKRP time {res_h.mttkrp_seconds:.2f}s of {res_h.total_seconds:.2f}s")
