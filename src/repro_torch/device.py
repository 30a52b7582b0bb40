"""Device resolution shared by every entry point of the port, and the two
execution guards of its LM loops: no host read (``no_host_sync``) and
run-to-run identical kernels (``deterministic_algorithms``)."""
from __future__ import annotations

import contextlib
import os

import torch
import torch.utils.deterministic


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent.  Nothing falls back to the CPU: only an explicit ``"cpu"``
    runs there.  An explicit ``"meta"`` is accepted for the dry run
    (``launch.dryrun``): its tensors have shapes and no storage, so a
    step runs without computing anything."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r} (cuda, cpu or meta)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:   # "cuda" and "cuda:<current>" are one device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def no_host_sync(dev):
    """On the card, any operation that waits for the device raises inside."""
    if dev.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


CUBLAS_CONFIG = "CUBLAS_WORKSPACE_CONFIG"


@contextlib.contextmanager
def deterministic_algorithms():
    """Inside, PyTorch runs its deterministic kernels
    (``torch.use_deterministic_algorithms(True)``), so a computation
    repeats bit for bit.  On CUDA this is what changes: the backward of a
    gather (advanced indexing, ``index_select``, ``torch.gather``) and
    ``index_add_`` / ``scatter_add_`` sum in a sorted, fixed order instead
    of with atomics.  cuBLAS repeats its results on one stream with a
    workspace of its own, which PyTorch gives every stream; PyTorch asks
    for ``CUBLAS_WORKSPACE_CONFIG`` to be set all the same before it runs
    a matmul in this mode, so it is set to ``:4096:8`` inside when unset.
    Uninitialized memory is not filled (the mode's debugging aid: the
    models read nothing they did not write).  Every setting is restored
    on exit."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory,
            os.environ.get(CUBLAS_CONFIG))
    if prev[3] is None:
        os.environ[CUBLAS_CONFIG] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.utils.deterministic.fill_uninitialized_memory = prev[2]
        if prev[3] is None:
            os.environ.pop(CUBLAS_CONFIG, None)
