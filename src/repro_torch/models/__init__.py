"""Model zoo of the port (part of ``repro.models``): the configuration and
shape registry (``base``), the decoder-only ``LM`` with its blocks,
attention and MLP, the shared machinery (``common``) and the
CPD-factorized embedding (``factorized_embed``), whose gradient runs the
paper's MTTKRP.  ``get_model`` serves the dense-segment families
(``dense``, ``vlm``); ``moe``, ``ssm``, ``hybrid`` and ``encdec`` wait
for a later slice and raise ``NotImplementedError``."""
from . import common, factorized_embed
from .base import SHAPES, ModelConfig, ShapeCfg, shape_applicable, token_specs
from .lm import LM


def get_model(cfg: ModelConfig):
    """The model of ``cfg``; ``LM`` raises ``NotImplementedError``, naming
    the family, for a family the port does not run yet."""
    return LM(cfg)


__all__ = [
    "SHAPES", "ModelConfig", "ShapeCfg", "shape_applicable", "token_specs",
    "LM", "get_model", "common", "factorized_embed",
]
