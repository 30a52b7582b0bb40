"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (import, the seeded stand-in tensor
made on the card, the program's plan, a warm-up call) is timed as
``setup_s``; then the cell's traffic runs for ``--seconds``.  With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled stretch of
whole calls after the window and from replays on the final state.  The
last line of standard output is one JSON object; the numbers compared
with the reference are printed last on standard error and under
``checks``.  Exits non-zero and prints no result without the cards the
cell asks for, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One process with one host thread: the window's host work (launches,
# uploads, the front door's numpy) then competes with nothing of its own,
# and runs spread less.  Set before numpy and torch are imported.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from bench.harness import cell, spec

    c = spec.find_cell(args.workload, spec.load_benchmark(ROOT))
    line = cell.run_cell(c, args.seed, args.seconds, bool(args.trace),
                         started=STARTED)
    return cell.emit(line)


if __name__ == "__main__":
    sys.exit(main())
