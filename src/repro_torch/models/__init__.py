"""Models of the port (part of ``repro.models``): the shared machinery
(``common``) and the CPD-factorized embedding (``factorized_embed``),
whose gradient runs the paper's MTTKRP.  The model zoo (``base``,
``lm``, ``encdec`` and the blocks) waits for a later slice."""
from . import common, factorized_embed

__all__ = ["common", "factorized_embed"]
