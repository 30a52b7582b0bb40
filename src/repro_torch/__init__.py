"""PyTorch/CUDA port of the sparse CPD-ALS system in ``repro``.

The main path -- one sparse CP decomposition of one tensor on one device --
is ``repro_torch.core.cpd.cpd_als`` -> ``core.als_device.cpd_als_fused``.
``cpd_als(method=...)`` also runs the decomposition methods of
``repro_torch.methods`` ('nncp', 'masked' with observation weights), and
``repro_torch.serve.BatchedEngine`` decomposes B same-bucket tensors in
lockstep on one device.  Users meet the service through
``DecompositionService`` (micro-batching scheduler and metrics) or
``runtime.ALSRunner``, and keep a decomposition current as nonzeros arrive
with ``methods.StreamingCP`` (checkpointed through
``checkpoint.CheckpointManager``).  ``core.distributed.cpd_als_distributed``
and ``BatchedEngine(mesh=...)`` run across the ranks of a
``repro_torch.launch`` mesh.  Their MTTKRP runs through the hand-written
Hopper kernel in ``csrc/mttkrp_slab.cu`` (the counterpart of the Pallas
kernel in ``repro/kernels/mttkrp_pallas.py``).  The LM models of
``repro_torch.models`` serve through ``launch.serve`` and train through
``launch.train`` (``runtime.Trainer``).

Entry points take ``device=`` and default to ``"cuda"``; they raise when
CUDA is asked for and absent.  ``device="cpu"`` runs every kernel's plain
PyTorch version instead.  The package imports torch and numpy only.
"""
from .core.als_device import cpd_als_fused
from .core.coo import SparseTensor, frostt_like, low_rank_sparse, random_sparse
from .core.cpd import CPDResult, cpd_als
from .methods import StreamingCP
from .runtime import ALSRunner
from .serve import BatchedEngine, DecompositionService

__all__ = [
    "ALSRunner",
    "BatchedEngine",
    "CPDResult",
    "DecompositionService",
    "SparseTensor",
    "StreamingCP",
    "cpd_als",
    "cpd_als_fused",
    "frostt_like",
    "low_rank_sparse",
    "random_sparse",
]
