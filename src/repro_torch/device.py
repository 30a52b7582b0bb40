"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent.  Nothing falls back to the CPU: only an explicit ``"cpu"``
    runs there."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:   # "cuda" and "cuda:<current>" are one device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
