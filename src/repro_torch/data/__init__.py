"""Data for the port: the LM token pipeline (``PipelineState``,
``TokenPipeline``) and the FROSTT ``.tns`` reader and writer."""
from .pipeline import PipelineState, TokenPipeline
from .tns import read_tns, write_tns

__all__ = ["PipelineState", "TokenPipeline", "read_tns", "write_tns"]
