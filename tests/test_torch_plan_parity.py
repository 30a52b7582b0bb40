"""Port vs JAX package: the paper's scheme choice priced by the cost model,
the fig-5 memory report, and the Hopper tile model, on the CPU.

``scheme_cost`` is a copy of the reference's, float arithmetic in the
same order, so its costs are held equal as floats and its choices equal,
over 3- and 4-mode powerlaw and uniform tensors, kappa in {2, 8, 82} (82
is the paper's RTX 3090 SM count) and both assignments.  Layouts built
under ``policy="cost"`` are bitwise the reference's, as are the memory
report's numbers.  ``make_plan(policy="cost")`` feeds the port's CPU
MTTKRP (the slab kernel's plain version, and segment), held within 1e-5
of the reference's ``segment`` MTTKRP.

The tile model is the port's own (priced for the slab kernel on Hopper,
not a TPU): its ``grid`` and ``pad_fraction`` are counted from the
layout's ``row_ptr`` as the reference counts them and must equal the
reference's for every shared ``(block_rows, tile)``, and ``grid`` equals
the slab count ``pack_layout`` makes.  Feasibility is the kernel's
shared-memory rule (``max_rank_block``).
"""
import importlib

import numpy as np
import pytest
import torch

from repro.core import coo as r_coo
from repro.core import layout as r_layout
from repro.core import load_balance as r_lb
from repro.core import make_plan as r_make_plan
from repro.core import mttkrp as r_mttkrp
from repro.kernels import ops as r_ops
from repro_torch.core import als_device
from repro_torch.core import coo as t_coo
from repro_torch.core import layout as t_layout
from repro_torch.core import load_balance as t_lb
from repro_torch.kernels import mttkrp_slab as ks
from repro_torch.kernels import ops as t_ops

# ``repro_torch.core`` exports the function ``mttkrp`` under the module's name.
t_mttkrp = importlib.import_module("repro_torch.core.mttkrp")

TOL = dict(rtol=1e-5, atol=1e-5)
TENSORS = [((40, 7, 33), 900), ((40, 7, 33, 5), 1500)]
KAPPAS = [2, 8, 82]


def _pair(shape, nnz, distribution, seed=3):
    return (r_coo.random_sparse(shape, nnz, seed=seed, distribution=distribution),
            t_coo.random_sparse(shape, nnz, seed=seed, distribution=distribution))


def assert_bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("assignment", ["greedy", "cyclic"])
@pytest.mark.parametrize("kappa", KAPPAS)
@pytest.mark.parametrize("distribution", ["powerlaw", "uniform"])
@pytest.mark.parametrize("shape,nnz", TENSORS)
def test_scheme_cost_equal_as_floats(shape, nnz, distribution, kappa, assignment):
    a, b = _pair(shape, nnz, distribution)
    for d in range(len(shape)):
        for scheme in (1, 2):
            ref = r_lb.scheme_cost(a, d, kappa, r_lb.Scheme(scheme),
                                   assignment=assignment)
            port = t_lb.scheme_cost(b, d, kappa, t_lb.Scheme(scheme),
                                    assignment=assignment)
            assert port == ref
        assert (t_lb.choose_scheme_cost_based(b, d, kappa, assignment=assignment).value
                == r_lb.choose_scheme_cost_based(a, d, kappa, assignment=assignment).value)


@pytest.mark.parametrize("kappa", KAPPAS)
def test_scheme_cost_under_another_profile(kappa):
    """A profile other than the default (here: a measured-looking one, with
    a faster memory and slower shared updates) prices alike in both."""
    a, b = _pair((40, 7, 33, 5), 1500, "powerlaw")
    kw = dict(bw=2.9e12, atomic_tput=4.0e10, rank=16)
    rp, tp = r_lb.DeviceProfile(**kw), t_lb.DeviceProfile(**kw)
    for d in range(4):
        for scheme in (1, 2):
            assert (t_lb.scheme_cost(b, d, kappa, t_lb.Scheme(scheme), profile=tp)
                    == r_lb.scheme_cost(a, d, kappa, r_lb.Scheme(scheme), profile=rp))
        assert (t_lb.choose_scheme_cost_based(b, d, kappa, profile=tp).value
                == r_lb.choose_scheme_cost_based(a, d, kappa, profile=rp).value)


def test_default_profile_is_the_references():
    import dataclasses

    assert (dataclasses.asdict(t_lb.DeviceProfile())
            == dataclasses.asdict(r_lb.DeviceProfile()))


@pytest.mark.parametrize("policy", ["cost", "threshold"])
@pytest.mark.parametrize("kappa", KAPPAS)
@pytest.mark.parametrize("distribution", ["powerlaw", "uniform"])
@pytest.mark.parametrize("shape,nnz", TENSORS)
def test_policy_layouts_bitwise_and_memory_report(shape, nnz, distribution,
                                                  kappa, policy):
    a, b = _pair(shape, nnz, distribution)
    la = r_layout.build_all_mode_layouts(a, kappa, policy=policy)
    lb = t_layout.build_all_mode_layouts(b, kappa, policy=policy)
    for x, y in zip(la, lb):
        assert x.scheme.value == y.scheme.value
        for field in ("indices", "rows", "values", "perm", "part_offsets",
                      "row_perm", "row_lo", "row_hi", "row_ptr"):
            assert_bitwise(getattr(x, field), getattr(y, field))
        assert x.nbytes() == y.nbytes()
    assert t_layout.format_memory_report(b, lb) == r_layout.format_memory_report(a, la)


def test_cost_policy_moves_the_boundary_mode():
    """The case the cost rule exists for: a mode just above kappa is scheme
    1 by the threshold and scheme 2 by the cost (as in the reference)."""
    a, b = _pair((100, 30, 20), 3000, "powerlaw", seed=1)
    kappa = 82
    thr = t_layout.build_mode_layout(b, 0, kappa)
    cost = t_layout.build_mode_layout(b, 0, kappa, policy="cost")
    assert thr.scheme == t_lb.Scheme.INDEX_PARTITION
    assert (cost.scheme.value
            == r_layout.build_mode_layout(a, 0, kappa, policy="cost").scheme.value)


@pytest.mark.parametrize("kappa", KAPPAS)
@pytest.mark.parametrize("shape,nnz", TENSORS)
def test_cost_plan_mttkrp_matches_reference_segment(shape, nnz, kappa):
    a, b = _pair(shape, nnz, "powerlaw", seed=9)
    rng = np.random.default_rng(kappa)
    F = [rng.standard_normal((I, 6)).astype(np.float32) for I in shape]
    rplan = r_make_plan(a, kappa, policy="cost")
    tplan = t_mttkrp.make_plan(b, kappa, policy="cost", device="cpu")
    assert ([l.scheme.value for l in tplan.layouts]
            == [l.scheme.value for l in rplan.layouts])
    for d in range(len(shape)):
        ref = np.asarray(r_mttkrp(rplan, F, d, backend="segment"))
        for backend in ("slab", "segment"):
            got = t_mttkrp.mttkrp(tplan, [torch.as_tensor(f) for f in F], d,
                                  backend=backend).numpy()
            np.testing.assert_allclose(got, ref, **TOL)


def test_plans_with_other_schemes_share_no_device_cache():
    t = t_coo.random_sparse((40, 7, 33), 900, seed=2, distribution="powerlaw")
    p1 = t_mttkrp.make_plan(t, 8, scheme=t_lb.Scheme.INDEX_PARTITION, device="cpu")
    p2 = t_mttkrp.make_plan(t, 8, scheme=t_lb.Scheme.NNZ_PARTITION, device="cpu")
    F = [torch.as_tensor(np.random.default_rng(0).standard_normal((I, 4)),
                         dtype=torch.float32) for I in t.shape]
    for d in range(3):
        outs = [t_mttkrp.mttkrp(p, F, d, backend="slab") for p in (p1, p2)]
        torch.testing.assert_close(outs[0], outs[1], **TOL)
        assert p1.device_packed(d) is not p2.device_packed(d)
        assert p1.device_packed(d)[5] is not p2.device_packed(d)[5]
    assert p1._dev_packed is not p2._dev_packed
    assert {l.scheme for l in p1.layouts} != {l.scheme for l in p2.layouts}


# -- the Hopper tile model ---------------------------------------------------


@pytest.mark.parametrize("distribution", ["powerlaw", "uniform"])
@pytest.mark.parametrize("shape,nnz", TENSORS + [((300, 20, 9), 4000)])
def test_tile_model_counts_match_reference_and_packing(shape, nnz, distribution):
    a, b = _pair(shape, nnz, distribution)
    assert t_ops.tile_candidates() == r_ops.tile_candidates()
    for x, y in zip(r_layout.build_all_mode_layouts(a, 4),
                    t_layout.build_all_mode_layouts(b, 4)):
        for br, tile in t_ops.tile_candidates():
            ref = r_ops.estimate_pack_cost(x, br, tile, 16, 64)
            port = t_ops.estimate_pack_cost(y, br, tile, 16)
            assert port["grid"] == ref["grid"]
            assert port["pad_fraction"] == ref["pad_fraction"]
            p = t_ops.pack_layout(y, block_rows=br, tile=tile)
            assert port["grid"] == p.num_slabs
            chunks = ks.slab_chunks(p.rb_of, p.num_row_blocks, "cpu")
            assert port["chunks"] == chunks.num_chunks
            assert port["groups"] == chunks.num_groups


@pytest.mark.parametrize("smem_limit", [ks.DEFAULT_SMEM_BYTES, 24 * 1024, 16 * 1024])
@pytest.mark.parametrize("rank", [16, 200])
def test_tile_model_feasibility_is_the_shared_memory_rule(smem_limit, rank):
    t = t_coo.random_sparse((300, 20, 9, 5), 4000, seed=1, distribution="powerlaw")
    lay = t_layout.build_mode_layout(t, 0, 1)
    W = 3
    feasible = []
    for br, tile in t_ops.tile_candidates():
        c = t_ops.estimate_pack_cost(lay, br, tile, rank, smem_limit=smem_limit)
        assert c["smem_ok"] == (ks.max_rank_block(br, smem_limit, W) >= 1)
        assert c["rank_block"] == ks.max_rank_block(br, smem_limit, W, widest=rank)
        assert c["rank_block"] == t_ops.auto_rank_block(rank, br, tile, 0, W,
                                                        smem_limit=smem_limit)
        if c["smem_ok"]:
            assert c["smem"] <= smem_limit
            assert c["num_rank_blocks"] == -(-rank // c["rank_block"])
            feasible.append((br, tile))
        else:
            assert c["cost"] == float("inf")
    pick = t_ops.auto_tiles(lay, rank, smem_limit=smem_limit)
    if feasible:
        assert pick in feasible
    else:
        assert pick == (t_ops.DEFAULT_BLOCK_ROWS, t_ops.DEFAULT_TILE)


@pytest.mark.parametrize("chunk_s", [0.0, 1e-6])
def test_tile_model_cost_is_bytes_over_rate_plus_chunks(chunk_s):
    t = t_coo.random_sparse((300, 20, 9), 4000, seed=5, distribution="powerlaw")
    lay = t_layout.build_mode_layout(t, 1, 1)
    for br, tile in t_ops.tile_candidates():
        c = t_ops.estimate_pack_cost(lay, br, tile, 16, bytes_per_s=1e12,
                                     chunk_s=chunk_s)
        nb = -(-lay.num_rows // br)
        slots = c["grid"] * tile
        tables = c["chunks"] + c["groups"] + 2 * nb + 4
        assert c["partial_bytes"] == 2 * (c["chunks"] + c["groups"]) * br * 16 * 4
        assert c["bytes"] == (slots * 4 * 4 + tables * 4 + (300 + 9) * 16 * 4
                              + nb * br * 16 * 4 + c["partial_bytes"])
        assert c["cost"] == pytest.approx(c["bytes"] / 1e12 + c["chunks"] * chunk_s)
    # A per-chunk time favours fewer, fuller chunks.
    pick = t_ops.auto_tiles(lay, 16, bytes_per_s=1e12, chunk_s=chunk_s)
    assert pick in t_ops.tile_candidates()


def test_plan_bucket_keeps_its_tiling():
    """The tile model is not behind ``plan_bucket``: every packing stays
    at (128, 256) unless pinned."""
    from repro_torch.core import plan as t_plan

    for shape in [(300, 20, 9), (40, 7, 33, 5)]:
        for m in t_plan.plan_bucket(shape, 4096, 16).modes:
            assert (m.block_rows, m.tile) == (128, 256)


@pytest.mark.parametrize("seed", [0, 4])
def test_init_state_uploads_the_host_init(seed):
    shape = (9, 7, 5)
    host = als_device.init_state_host(shape, 3, seed)
    dev = als_device.init_state(shape, 3, seed, device="cpu")
    for h, d in zip(host[0] + host[1], dev[0] + dev[1]):
        assert_bitwise(h, d.numpy())
    assert_bitwise(host[2], dev[2].numpy())
    if not torch.cuda.is_available():    # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            als_device.init_state(shape, 3, seed)


@pytest.mark.parametrize("num_modes,smem_limit,ranks", [
    (3, ks.DEFAULT_SMEM_BYTES, range(1, 120)),
    (4, ks.DEFAULT_SMEM_BYTES, range(1, 120)),
    (4, 232448, range(400, 412)),          # the H100's opt-in maximum
], ids=["3modes_48k", "4modes_48k", "4modes_227k"])
def test_plan_rank_block_fits_for_every_rank(num_modes, smem_limit, ranks):
    """A plan's rank block fits the kernel's shared memory whatever the
    rank: the widest fitting block of at most R columns, not ``min(R,
    max_rank_block)``.  Four-column blocks have more walkers than
    one-column ones, so a narrower block can overflow where a wider one
    fits: rank 60 at block_rows 128 and 48 KB for 2 input factors, rank
    408 at 227 KB for 3."""
    from repro_torch.core import plan as t_plan

    shape = (300, 20, 10, 6)[:num_modes]
    W = num_modes - 1
    for rank in ranks:
        for m in t_plan.plan_bucket(shape, 4096, rank, smem_limit=smem_limit).modes:
            assert 1 <= m.rank_block <= rank
            assert ks.smem_bytes(m.block_rows, m.rank_block,
                                 num_inputs=W) <= smem_limit
