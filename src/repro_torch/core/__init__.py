"""Core of the port: the paper's contribution -- mode-specific spMTTKRP +
CPD-ALS (port of ``repro.core``; the same public names).

Public API:
  SparseTensor, random_sparse, low_rank_sparse, frostt_like   (coo)
  Scheme, partition_mode, choose_scheme                       (load_balance)
  ModeLayout, build_mode_layout, build_all_mode_layouts       (layout)
  MTTKRPPlan, make_plan, mttkrp                               (mttkrp)
  cpd_als, CPDResult                                          (cpd)
"""
from .als_device import cpd_als_fused, state_from_factors, sweep_cache_stats
from .coo import SparseTensor, frostt_like, low_rank_sparse, random_sparse
from .cpd import CPDResult, cpd_als
from .layout import ModeLayout, build_all_mode_layouts, build_mode_layout, format_memory_report
from .load_balance import (DeviceProfile, Partitioning, Scheme,
                           balance_bound_holds, choose_scheme,
                           choose_scheme_cost_based, partition_mode,
                           scheme_cost)
from .mttkrp import MTTKRPPlan, make_plan, mttkrp, mttkrp_dense_ref
from .plan import (DeviceShards, ModePlan, PartitionPlan,
                   build_device_shards, density_profile, plan_bucket,
                   plan_layout, plan_tensor, quantize_nnz, slab_cap)

__all__ = [
    "DeviceShards", "ModePlan", "PartitionPlan", "build_device_shards",
    "plan_bucket", "plan_layout", "plan_tensor", "quantize_nnz", "slab_cap",
    "SparseTensor", "frostt_like", "low_rank_sparse", "random_sparse",
    "CPDResult", "cpd_als", "cpd_als_fused", "state_from_factors",
    "sweep_cache_stats", "density_profile",
    "ModeLayout", "build_all_mode_layouts", "build_mode_layout", "format_memory_report",
    "DeviceProfile", "Partitioning", "Scheme", "balance_bound_holds",
    "choose_scheme", "choose_scheme_cost_based", "partition_mode", "scheme_cost",
    "MTTKRPPlan", "make_plan", "mttkrp", "mttkrp_dense_ref",
]
