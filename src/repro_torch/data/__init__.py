"""Tensor input for the port: the FROSTT ``.tns`` reader and writer.
(The reference's LM token pipeline is not ported yet.)"""
from .tns import read_tns, write_tns

__all__ = ["read_tns", "write_tns"]
