"""CPD of a FROSTT-like tensor on the PyTorch/CUDA port, comparing
execution engines and load-balancing schemes.

    PYTHONPATH=src python examples/decompose_tensor_torch.py [dataset] \
        [--segment] [--host] [--device cuda|cpu]

The default backend is the slab kernel (``--segment`` takes the sorted
segmented reduction instead); ``--host`` uses the per-mode host loop, the
default is the fused device-resident engine.  The default device is the
card.
"""
import argparse
import time

from repro_torch.core import Scheme, cpd_als, frostt_like, make_plan

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("dataset", nargs="?", default="chicago")
parser.add_argument("--segment", action="store_true")
parser.add_argument("--host", action="store_true")
parser.add_argument("--device", default="cuda")
args = parser.parse_args()
engine = "host" if args.host else "fused"
backend = "segment" if args.segment else "slab"
t = frostt_like(args.dataset, scale=0.01, seed=0)
print(f"{args.dataset}: shape={t.shape} nnz={t.nnz} engine={engine}")

for label, scheme in [("adaptive", None),
                      ("scheme-1 only", Scheme.INDEX_PARTITION),
                      ("scheme-2 only", Scheme.NNZ_PARTITION)]:
    plan = make_plan(t, kappa=82, scheme=scheme, device=args.device)
    t0 = time.perf_counter()
    res = cpd_als(t, rank=32, plan=plan, n_iters=3, backend=backend,
                  engine=engine, check_every=3, tol=-1.0, device=args.device)
    wall = time.perf_counter() - t0
    print(f"  {label:14s} [{backend}/{res.engine}]: fit={res.fits[-1]:.4f} "
          f"wall={wall:.3f}s syncs={res.host_syncs}")
