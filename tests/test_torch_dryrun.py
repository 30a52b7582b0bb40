"""Port vs JAX package: the dry run (``repro_torch.launch.dryrun``,
``launch.op_analysis``, ``HW`` and ``make_production_mesh``) on the CPU.

* ``roofline_terms`` equals the reference's under both packages' ``HW``;
  ``collective_stats`` on the records of the reference's HLO sample
  equals ``parse_collectives`` on the sample.
* ``_activation_bytes``, ``_attention_correction``, ``_with_layers`` and
  ``_extrapolate`` equal the reference's for every arch, applicable shape
  and both production meshes; the state bytes per device (parameters
  with the optimizer state or the cache) equal the reference's, its specs
  resolved by its own ``launch.shardings`` on a stand-in mesh.
* Counts: probes at depths 2 and 4 extrapolate to depth 6's count
  exactly (dense, moe, ssm); the counted attention products equal the
  analytic formula without the reference's once-counted discount; one
  reduced train step counts the same on ``meta`` and on the CPU.
* ``run_cell`` on a reduced internvl2-1b over small meshes (4 x 2 and
  2 x 2 x 2, as the reference's slow test) returns a dominant term.

The reference's ``dryrun`` module sets ``XLA_FLAGS`` when it is imported;
the fixture brings JAX's backend up first and restores the variable, so
the worker's later JAX tests see the devices they would have seen.
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.launch import hlo_analysis as rhlo
from repro.launch import mesh as rmesh
from repro.launch import shardings as rshd
from repro.models import common as rcommon
from repro_torch import configs, optim
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.mesh import HW, AbstractMesh, make_production_mesh
from repro_torch.models import SHAPES, ShapeCfg, common, get_model, shape_applicable

ARCHS = list(rconfigs.ARCHS)
HLO_SAMPLE = """
  %ag = bf16[16,256] all-gather(%x), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar.1 = f32[1024] all-reduce(%y), replica_groups={{0,1}}, to_apply=%add
  %rs = f32[64] reduce-scatter(%z), replica_groups={{0,1,2,3}}
  %cp = bf16[8,8] collective-permute(%w), source_target_pairs={{0,1}}
  %mm = f32[8,8] dot(%a, %b)
"""
# The sample's collectives as (kind, per-device result bytes, group size).
HLO_RECORDS = [("all-gather", 16 * 256 * 2, 4), ("all-reduce", 1024 * 4, 2),
               ("reduce-scatter", 64 * 4, 4), ("collective-permute", 8 * 8 * 2, None)]


@pytest.fixture(scope="module")
def rdry():
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


@pytest.fixture(autouse=True)
def _rules():
    common.reset_rules()
    rcommon.reset_rules()
    yield
    common.reset_rules()
    rcommon.reset_rules()


class _StandInMesh:
    """What the reference's sharding code reads of a mesh."""

    def __init__(self, mesh: AbstractMesh):
        self.axis_names = mesh.axis_names
        self.devices = types.SimpleNamespace(shape=mesh.axis_sizes)


class _StandInSharding:
    """A ``NamedSharding`` that needs no devices: its mesh and spec."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


def _meshes():
    return [make_production_mesh(), make_production_mesh(multi_pod=True)]


def _cells(arch):
    """(port cfg, reference cfg, shape name) of each applicable shape."""
    pcfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    return [(pcfg, rcfg, s) for s in SHAPES if shape_applicable(pcfg, SHAPES[s])[0]]


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


# ---------------------------------------------------------------------------
# The table, the meshes and the pure functions
# ---------------------------------------------------------------------------

def test_hw_is_the_h100_and_the_meshes_are_the_references():
    assert HW["name"] == "h100_sxm" and HW["sm_count"] == 132
    assert (HW["peak_flops_bf16"], HW["hbm_bw"], HW["hbm_bytes"]) == (989e12, 3.35e12, 80e9)
    assert set(rmesh.HW) - {"vmem_bytes"} <= set(HW)
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        want = ("pod", "data", "model") if mp else ("data", "model")
        assert mesh.axis_names == want
        assert common.mesh_shape(mesh) == dict(zip(want, (2, 16, 16) if mp else (16, 16)))
        assert mesh.size == (512 if mp else 256)


@pytest.mark.parametrize("hw", ["reference", "port"])
def test_roofline_terms_match_the_reference(hw):
    table = rmesh.HW if hw == "reference" else HW
    for flops, by, wire in [(197e12, 0, 0), (0, 819e9, 1), (1, 1, 50e9),
                            (3.2e15, 7.1e12, 4.4e11), (0, 0, 0)]:
        kw = dict(flops=flops, hbm_bytes=by, wire_bytes=wire, n_chips=256, hw=table)
        assert op_analysis.roofline_terms(**kw) == rhlo.roofline_terms(**kw)


def test_collective_stats_match_parse_collectives():
    want = rhlo.parse_collectives(HLO_SAMPLE, group_size=4)
    got = op_analysis.collective_stats(HLO_RECORDS, group_size=4)
    assert got.as_dict() == want.as_dict()
    assert got.counts == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
                          "collective-permute": 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_functions_match_the_reference(arch, rdry):
    for pcfg, rcfg, s in _cells(arch):
        pshape, rshape = SHAPES[s], rmodels.SHAPES[s]
        assert dryrun._attention_correction(pcfg, pshape) == rdry._attention_correction(
            rcfg, rshape)
        for mesh in _meshes():
            assert dryrun._activation_bytes(pcfg, pshape, mesh) == rdry._activation_bytes(
                rcfg, rshape, _StandInMesh(mesh))
    pcfg, rcfg = configs.get_config(arch), rconfigs.get_config(arch)
    for L in (2, 4, 5, 9):
        assert _fields(dryrun._with_layers(pcfg, L)) == _fields(rdry._with_layers(rcfg, L))
    c1 = {"flops": 3.0e12, "bytes": 1.5e11, "wire": 7.0e9, "counts": {"all-gather": 9}}
    c2 = {"flops": 5.5e12, "bytes": 2.25e11, "wire": 1.1e10,
          "counts": {"all-gather": 17, "all-reduce": 3}}
    for L1, L2, L in [(2, 4, 24), (5, 9, 32)]:
        assert dryrun._extrapolate(c1, c2, L1, L2, L) == rdry._extrapolate(c1, c2, L1, L2, L)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_bytes_match_the_reference(arch, rdry, monkeypatch):
    monkeypatch.setattr(rshd, "NamedSharding", _StandInSharding)
    monkeypatch.setattr(rdry, "NamedSharding", _StandInSharding)
    for pcfg, rcfg, s in _cells(arch):
        shape = SHAPES[s]
        rmodel = rmodels.get_model(rcfg)
        rparams = rmodel.abstract_params()
        for mesh in _meshes():
            stand_in = _StandInMesh(mesh)
            p_shard = rshd.param_shardings(rmodel, stand_in)
            want = rdry._sharded_nbytes(rparams, p_shard)
            if shape.kind == "train":
                ropt = jax.eval_shape(rdry.optim.init_state, rparams)
                want += rdry._sharded_nbytes(
                    ropt, rshd.opt_state_shardings(p_shard, stand_in))
            else:
                rcache = jax.eval_shape(lambda: rmodel.init_cache(
                    shape.global_batch, shape.seq_len, dtype=jnp.bfloat16))
                want += rdry._sharded_nbytes(rcache, rshd.cache_shardings(
                    rcache, stand_in, seq_axis_ok=shape.kind == "decode"))
            _, _, got = dryrun._build(pcfg, shape, mesh, quant_kv=False, microbatch=1)
            assert got == want, (s, mesh)
            common.reset_rules()


# ---------------------------------------------------------------------------
# Counts
# ---------------------------------------------------------------------------

SMALL_MESH = AbstractMesh(("data", "model"), (2, 2))
ONE_RANK = AbstractMesh(("data", "model"), (1, 1))


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "granite-moe-1b-a400m", "mamba2-780m"])
def test_probes_extrapolate_exactly(arch):
    cfg = configs.reduce_config(configs.get_config(arch))
    shape = ShapeCfg("probe", 64, 4, "train")
    c = {L: dryrun._count_costs(dryrun._with_layers(cfg, L), shape, SMALL_MESH,
                                quant_kv=False, microbatch=1) for L in (2, 4, 6)}
    est = dryrun._extrapolate(c[2], c[4], 2, 4, 6)
    for k in ("flops", "bytes", "wire", "counts"):
        assert est[k] == c[6][k], k
    assert c[6]["flops"] > c[4]["flops"] > 0 and c[6]["counts"]


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_counted_attention_products_equal_the_analytic_count(kind):
    # remat as the production configs have it: the analytic count assumes
    # the forward, its recomputation and the backward's two products.
    cfg = dataclasses.replace(configs.reduce_config(configs.get_config("qwen1.5-4b")),
                              remat="full")
    shape = ShapeCfg("attn", 2 * cfg.attn_chunk, 2, kind)
    step, args, _ = dryrun._build(cfg, shape, ONE_RANK, quant_kv=False, microbatch=1)
    counted = dryrun._run(step, args)["flops_by_op"]["aten.bmm"]
    whole, _ = dryrun._attention_correction(cfg, shape, once_counted=False)
    assert counted == whole
    assert dryrun._attention_correction(cfg, shape)[0] == whole * (1 - 1 / 4)


def test_counts_on_meta_equal_counts_on_the_cpu():
    cfg = dataclasses.replace(configs.reduce_config(configs.get_config("internvl2-1b")),
                              num_layers=2, remat="full")
    shape = ShapeCfg("count", 64, 2, "train")
    step, args, _ = dryrun._build(cfg, shape, ONE_RANK, quant_kv=False, microbatch=1)
    on_meta = dryrun._run(step, args)
    params = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: (torch.randn(v.shape, generator=gen).to(v.dtype) if v.is_floating_point()
                 else torch.randint(0, cfg.vocab_size, v.shape, generator=gen, dtype=v.dtype))
             for k, v in args[2].items()}
    on_cpu = dryrun._run(step, (params, optim.init_state(params), batch))
    assert on_cpu == on_meta
    assert on_meta["flops"] > 0 and on_meta["bytes"] > 0
    assert on_meta["peak_live_bytes"] > on_meta["argument_size_in_bytes"]


def test_run_cell_on_small_meshes(monkeypatch):
    def small_mesh(*, multi_pod=False):
        if multi_pod:
            return AbstractMesh(("pod", "data", "model"), (2, 2, 2))
        return AbstractMesh(("data", "model"), (4, 2))

    # One attention chunk keeps the count of the reduced config short.
    real = configs.get_config
    monkeypatch.setattr(dryrun, "make_production_mesh", small_mesh)
    monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.replace(
        configs.reduce_config(real(a)), num_layers=6, attn_chunk=4096))
    for mp in (False, True):
        r = dryrun.run_cell("internvl2-1b", "train_4k", multi_pod=mp)
        assert "error" not in r and "skipped" not in r, r
        assert r["mesh"] == ("2x2x2" if mp else "4x2") and r["n_chips"] == 8
        assert r["counted_flops_per_chip"] > 0 and r["counted_bytes_per_chip"] > 0
        assert r["collective_wire_bytes_per_chip"] >= 0
        assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
        mem = r["memory_analysis"]
        assert mem["peak_live_bytes_one_rank"] > mem["argument_size_in_bytes"] > 0
    assert common.get_rules() == rcommon.get_rules()
