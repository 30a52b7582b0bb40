"""Model zoo of the port (port of ``repro.models``): the configuration and
shape registry (``base``), the decoder-only ``LM`` with its blocks
(dense, MoE, Mamba2, Hymba), attention, MLP and SSD, the
encoder-decoder ``EncDec`` (Whisper), the shared machinery (``common``)
and the CPD-factorized embedding (``factorized_embed``), whose gradient
runs the paper's MTTKRP.  ``get_model`` serves every family."""
from . import common, factorized_embed
from .base import SHAPES, ModelConfig, ShapeCfg, shape_applicable, token_specs
from .encdec import EncDec
from .lm import LM


def get_model(cfg: ModelConfig):
    if cfg.family == "encdec":
        return EncDec(cfg)
    return LM(cfg)


__all__ = [
    "SHAPES", "ModelConfig", "ShapeCfg", "shape_applicable", "token_specs",
    "EncDec", "LM", "get_model", "common", "factorized_embed",
]
