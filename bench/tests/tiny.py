"""A cell of the benchmark cut to a size the CPU tests can run."""
from bench.harness import spec

TINY = {"shape": [40, 12, 9, 16], "nnz": 1500, "rank": 8}


def tiny_cell(workload: str = "chicago.restarts"):
    cell = spec.find_cell(workload, spec.load_benchmark())
    cell.config = dict(cell.config, **TINY)
    return cell
