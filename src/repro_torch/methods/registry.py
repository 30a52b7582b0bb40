"""Decomposition-method registry (port of ``repro.methods.registry``).

A method plugs an update rule into the sweep the engines already run
(``core.als_device.build_lane_sweep``).  The substrate owns the MTTKRP
backends and kernels, the partition plans, the check windows, the window
caches and the batched service; a method owns only what differs:

  * ``update(ctx, d, M, factors, grams, weights, rescue) -> (Yd, lam,
    ok)`` -- the mode-d update from the MTTKRP ``M`` (None: CP's ridge
    solve); ``ok`` is an on-device solve flag or None;
  * ``mttkrp_values(ctx, factors, weights, fit_data) -> (nnz,)`` -- fresh
    canonical-order values the mode's MTTKRP runs on through the valued
    kernel entry (None: the values baked into the packing).  Set, the
    method runs on structural mode data;
  * ``shard_values(ctx, factors, weights, shard) -> (nnz_shard,)`` -- the
    same values at a rank's valued shard of one mode (the distributed
    engine; ``core.plan.DeviceShards`` with full indices), in the shard's
    order.  None: the method's valued sweep does not distribute;
  * ``init_state_host(shape, rank, seed)`` -- seeded host init (None:
    the shared default);
  * ``make_fit_data(tensor, entry_weights, device)`` -- per-request fit
    inputs when the method's fit differs (None: CP's);
  * ``weighted_fit`` -- the fit is the weighted observed-entry fit and
    the front doors accept per-entry ``weights=``;
  * ``stateful`` -- the method drives the substrate across calls through a
    session of its own instead of a sweep ('streaming'), so the sweep
    engines and the batched service refuse it; ``session_factory`` builds
    that session.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """One decomposition method's contract with the substrate."""

    name: str
    description: str = ""
    update: Callable | None = None
    mttkrp_values: Callable | None = None
    shard_values: Callable | None = None
    init_state_host: Callable | None = None
    make_fit_data: Callable | None = None
    weighted_fit: bool = False
    stateful: bool = False
    session_factory: Callable | None = None

    @property
    def valued_mode_data(self) -> bool:
        """True: mode data is structural only and each sweep threads fresh
        values through the valued MTTKRP entry."""
        return self.mttkrp_values is not None


_REGISTRY: dict[str, MethodSpec] = {}


def register_method(spec: MethodSpec, *, override: bool = False) -> MethodSpec:
    if not override and spec.name in _REGISTRY:
        raise ValueError(f"method {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_method(name: str) -> MethodSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown decomposition method {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def list_methods() -> list[str]:
    return sorted(_REGISTRY)


def batchable_methods() -> list[str]:
    """Methods the batched service can run (the stateful ones drive it
    through their sessions instead)."""
    return sorted(n for n, s in _REGISTRY.items() if not s.stateful)
