"""What a run refuses to measure: a machine without the cards the cell
asks for, and a process into which the JAX package or JAX was loaded."""
from __future__ import annotations

import sys

# Compared with each loaded module's top-level name, whole: the port,
# ``repro_torch``, is not ``repro``.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: the
    modules loaded in this process)."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def require_cards(count: int) -> None:
    """Raise unless CUDA is available with at least ``count`` cards."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False, and the benchmark never runs on the CPU")
    have = torch.cuda.device_count()
    if have < count:
        raise RuntimeError(f"the cell asks for {count} cards, {have} present")
