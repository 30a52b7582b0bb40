"""Port vs JAX package: the host-side stages are bitwise equal.

Same numpy-seeded inputs go through ``repro`` (the reference) and
``repro_torch``: the COO generators, the load-balancing partitions, the
mode layouts, the slab packing (pinned tiling, with and without a slab
cap), the plan's caps and the seeded CP init must give the same bytes.
"""
import numpy as np
import pytest

from repro.core import coo as r_coo
from repro.core import layout as r_layout
from repro.core import load_balance as r_lb
from repro.core import plan as r_plan
from repro.core.als_device import init_state_host as r_init
from repro.kernels import ops as r_ops
from repro_torch.core import coo as t_coo
from repro_torch.core import layout as t_layout
from repro_torch.core import load_balance as t_lb
from repro_torch.core import plan as t_plan
from repro_torch.core.als_device import init_state_host as t_init
from repro_torch.kernels import ops as t_ops

SHAPES = [((16, 12, 9), 400), ((40, 7, 33, 5), 1500), ((9, 6, 5, 4, 3), 300)]


def assert_bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("distribution", ["uniform", "zipf", "powerlaw"])
@pytest.mark.parametrize("shape,nnz", SHAPES)
def test_random_sparse_bitwise(shape, nnz, distribution):
    a = r_coo.random_sparse(shape, nnz, seed=5, distribution=distribution)
    b = t_coo.random_sparse(shape, nnz, seed=5, distribution=distribution)
    assert a.shape == b.shape
    assert_bitwise(a.indices, b.indices)
    assert_bitwise(a.values, b.values)


@pytest.mark.parametrize("seed", [0, 3])
def test_low_rank_sparse_bitwise(seed):
    a, fa = r_coo.low_rank_sparse((20, 15, 10), 500, 4, seed=seed, noise=0.1)
    b, fb = t_coo.low_rank_sparse((20, 15, 10), 500, 4, seed=seed, noise=0.1)
    assert_bitwise(a.indices, b.indices)
    assert_bitwise(a.values, b.values)
    for x, y in zip(fa, fb):
        assert_bitwise(x, y)


@pytest.mark.parametrize("name", ["chicago", "uber", "vast"])
def test_frostt_like_bitwise(name):
    a = r_coo.frostt_like(name, scale=2e-4, seed=1)
    b = t_coo.frostt_like(name, scale=2e-4, seed=1)
    assert a.shape == b.shape
    assert_bitwise(a.indices, b.indices)
    assert_bitwise(a.values, b.values)


def test_frostt_shapes_match():
    assert t_coo.FROSTT_SHAPES == r_coo.FROSTT_SHAPES
    idx = np.array([[1, 2, 3], [0, 0, 1]], np.int32)
    assert_bitwise(r_coo._linearize(idx, (4, 5, 6)),
                   t_coo._linearize(idx, (4, 5, 6)))


@pytest.mark.parametrize("kappa", [1, 3, 8, 64])
@pytest.mark.parametrize("assignment", ["greedy", "cyclic"])
def test_partitions_bitwise(kappa, assignment):
    t = r_coo.random_sparse((40, 7, 33, 5), 1500, seed=2, distribution="powerlaw")
    for d in range(t.nmodes):
        assert (t_lb.choose_scheme(t.shape[d], kappa).value
                == r_lb.choose_scheme(t.shape[d], kappa).value)
        a = r_lb.partition_mode(t, d, kappa, assignment=assignment)
        b = t_lb.partition_mode(t, d, kappa, assignment=assignment)
        assert a.scheme.value == b.scheme.value
        assert_bitwise(a.perm, b.perm)
        assert_bitwise(a.offsets, b.offsets)
        if a.vertex_part is None:
            assert b.vertex_part is None
        else:
            assert_bitwise(a.vertex_part, b.vertex_part)
        assert a.imbalance() == b.imbalance()


@pytest.mark.parametrize("kappa,seed,mode_count",
                         [(2, 0, 2), (8, 13, 3), (64, 999, 3), (5, 7, 2), (33, 41, 3)])
@pytest.mark.parametrize("scheme", ["INDEX_PARTITION", "NNZ_PARTITION"])
def test_balance_bound_matches_reference(kappa, seed, mode_count, scheme):
    """Graham's 4/3 bound on the partitions of
    ``tests/core/test_load_balance.py::_graham_bound_case`` (greedy scheme 1),
    and on scheme-2 and cyclic splits of the same tensors: the port's
    ``balance_bound_holds`` gives the reference's boolean."""
    shape = (37, 23, 11)[:mode_count] + (29,)
    rt = r_coo.random_sparse(shape, 600, seed=seed, distribution="powerlaw")
    tt = t_coo.random_sparse(shape, 600, seed=seed, distribution="powerlaw")
    for d in range(rt.nmodes):
        for assignment in ("greedy", "cyclic"):
            a = r_lb.partition_mode(rt, d, kappa, scheme=r_lb.Scheme[scheme],
                                    assignment=assignment)
            b = t_lb.partition_mode(tt, d, kappa, scheme=t_lb.Scheme[scheme],
                                    assignment=assignment)
            assert (t_lb.balance_bound_holds(b, tt)
                    == r_lb.balance_bound_holds(a, rt))
        if scheme == "INDEX_PARTITION":
            assert t_lb.balance_bound_holds(
                t_lb.partition_mode(tt, d, kappa, scheme=t_lb.Scheme[scheme]), tt)


@pytest.mark.parametrize("shape,nnz", SHAPES)
@pytest.mark.parametrize("kappa", [1, 4, 16])
def test_layouts_bitwise(shape, nnz, kappa):
    t = r_coo.random_sparse(shape, nnz, seed=4, distribution="powerlaw")
    for a, b in zip(r_layout.build_all_mode_layouts(t, kappa),
                    t_layout.build_all_mode_layouts(t, kappa)):
        assert a.scheme.value == b.scheme.value
        for field in ("indices", "rows", "values", "perm", "part_offsets",
                      "row_perm", "row_lo", "row_hi", "row_ptr"):
            assert_bitwise(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("block_rows,tile", [(8, 16), (16, 64), (128, 256)])
@pytest.mark.parametrize("capped", [False, True])
def test_packing_bitwise(block_rows, tile, capped):
    t = r_coo.random_sparse((40, 7, 33, 5), 1500, seed=6, distribution="powerlaw")
    w = np.random.default_rng(1).random(t.nnz).astype(np.float32)
    for a_lay, b_lay in zip(r_layout.build_all_mode_layouts(t, 4),
                            t_layout.build_all_mode_layouts(t, 4)):
        cap = (r_plan.slab_cap(a_lay.num_rows, t.nnz + 700, block_rows, tile)
               if capped else None)
        for weights in (None, w):
            a = r_ops.pack_layout(a_lay, block_rows=block_rows, tile=tile,
                                  num_slabs_cap=cap, weights=weights)
            b = t_ops.pack_layout(b_lay, block_rows=block_rows, tile=tile,
                                  num_slabs_cap=cap, weights=weights)
            for field in ("rb_of", "first", "idx_packed", "vals_packed",
                          "lrows_packed", "val_scatter"):
                assert_bitwise(getattr(a, field), getattr(b, field))
            assert_bitwise(a.weighted_vals(), b.weighted_vals())
            assert (a.num_row_blocks, a.num_real_slabs, a.input_modes,
                    a.pad_fraction) == (b.num_row_blocks, b.num_real_slabs,
                                        b.input_modes, b.pad_fraction)
            if capped:
                assert b.num_slabs == cap


@pytest.mark.parametrize("nnz", [1, 127, 128, 129, 5000])
@pytest.mark.parametrize("mode", ["quantum", "geometric"])
def test_quantize_nnz_matches(nnz, mode):
    assert t_plan.quantize_nnz(nnz, mode=mode) == r_plan.quantize_nnz(nnz, mode=mode)


@pytest.mark.parametrize("block_rows,tile", [(8, 32), (128, 256)])
def test_plan_caps_match_pinned_tiling(block_rows, tile):
    """With the tiling pinned, the port's plan makes the reference's caps
    (the rank block is the port's own and is pinned too)."""
    shape, cap = (40, 7, 33, 5), 2048
    a = r_plan.plan_bucket(shape, cap, 8, block_rows=block_rows, tile=tile)
    b = t_plan.plan_bucket(shape, cap, 8, block_rows=block_rows, tile=tile,
                           rank_block=8)
    for ma, mb in zip(a.modes, b.modes):
        assert (ma.num_rows, ma.num_row_blocks, ma.slab_cap, ma.nnz_cap) == (
            mb.num_rows, mb.num_row_blocks, mb.slab_cap, mb.nnz_cap)
        assert mb.rank_block == 8
    t = r_coo.random_sparse(shape, 1000, seed=0)
    assert (t_plan.plan_tensor(t, 8, block_rows=block_rows, tile=tile).nnz_cap
            == r_plan.plan_tensor(t, 8).nnz_cap)


def test_plan_rank_block_from_shared_memory():
    """Auto rank blocks fit the kernel's shared memory and never exceed R."""
    from repro_torch.kernels import mttkrp_slab as ks

    # Each mode of a 3-mode tensor has two input factors, whose slot
    # streams the kernel's ring holds: at the CPU default of 48 KB the
    # widest block is 62 columns.
    p = t_plan.plan_bucket((300, 20, 10), 4096, 64)
    for m in p.modes:
        assert m.rank_block == 62
        assert ks.smem_bytes(m.block_rows, m.rank_block,
                             num_inputs=2) <= ks.DEFAULT_SMEM_BYTES
    wide = t_plan.plan_bucket((300, 20, 10), 4096, 4000)
    rb = wide.modes[0].rank_block
    assert 1 <= rb < 4000
    assert ks.smem_bytes(128, rb, num_inputs=2) <= ks.DEFAULT_SMEM_BYTES
    assert (ks.smem_bytes(128, rb + 1, num_inputs=2) > ks.DEFAULT_SMEM_BYTES
            or rb == ks.MAX_THREADS)


@pytest.mark.parametrize("shape,rank,seed", [((16, 12, 9), 4, 0),
                                             ((40, 7, 33, 5), 8, 11)])
def test_init_state_host_bitwise(shape, rank, seed):
    a = r_init(shape, rank, seed)
    b = t_init(shape, rank, seed)
    for part_a, part_b in zip(a[:2], b[:2]):
        for x, y in zip(part_a, part_b):
            assert_bitwise(x, y)
    assert_bitwise(a[2], b[2])
