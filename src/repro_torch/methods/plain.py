"""The registry entry for unconstrained CP-ALS.

Its update is the substrate's inline one (``core.als_device.cp_update``:
ridge normal equations with the on-device failure flag and pinv rescue,
then column normalization); ``method="cp"`` takes it without a registry
lookup.  The entry exists so 'cp' is listed and validated like the rest.
"""
from __future__ import annotations

from .registry import MethodSpec, register_method

CP = register_method(MethodSpec(
    name="cp",
    description="Unconstrained CP-ALS (ridge-regularized normal equations "
                "with pinv rescue), the substrate's inline update.",
))
