"""Port vs JAX package: the MTTKRP oracles, the slab kernel's plain version
and the MTTKRP front door.

Tolerances: rtol 1e-5 / atol 1e-5 wherever the two packages sum the same
float32 terms in another order (``index_add_`` vs ``segment_sum`` vs the
Pallas kernel's one-hot matmuls).  Results that must be exact (cap slabs
adding +0.0, the CPU wrapper being the plain version) are compared
bitwise.  The card's
cases are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coo as r_coo
from repro.core import make_plan as r_make_plan
from repro.core import mttkrp as r_mttkrp
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels.mttkrp_pallas import mttkrp_pallas
from repro_torch.core import mttkrp as t_mttkrp
from repro_torch.core.coo import random_sparse
from repro_torch.kernels import mttkrp_slab as ks
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _factors(shape, R, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((I, R)).astype(np.float32) for I in shape]


def _t(arrays, dtype=None):
    out = [torch.as_tensor(a) for a in arrays]
    return [o.to(dtype) for o in out] if dtype is not None else out


def _plain(packed, factors):
    idx, vals, lrows, rb_of = (torch.as_tensor(a) for a in (
        packed.idx_packed, packed.weighted_vals(), packed.lrows_packed,
        packed.rb_of))
    return ks.mttkrp_slab_plain(
        idx, vals, lrows, rb_of, factors, num_row_blocks=packed.num_row_blocks,
        block_rows=packed.block_rows, tile=packed.tile).numpy()


def _pallas(packed, factors, rank_block=None):
    return np.asarray(mttkrp_pallas(
        jnp.asarray(packed.rb_of), jnp.asarray(packed.first),
        jnp.asarray(packed.idx_packed), jnp.asarray(packed.weighted_vals()),
        jnp.asarray(packed.lrows_packed), [jnp.asarray(f) for f in factors],
        num_row_blocks=packed.num_row_blocks, block_rows=packed.block_rows,
        tile=packed.tile, rank_block=rank_block, interpret=True))


@pytest.mark.parametrize("shape,nnz,R", [
    ((16, 12, 9), 400, 4),
    ((40, 7, 33, 5), 1200, 8),
    ((9, 6, 5, 4, 3), 300, 5),
])
def test_ref_oracles_match(shape, nnz, R):
    t = r_coo.random_sparse(shape, nnz, seed=1, distribution="powerlaw")
    F = _factors(shape, R, seed=2)
    idx, vals = torch.as_tensor(t.indices), torch.as_tensor(t.values)
    for d in range(t.nmodes):
        a = np.asarray(r_ref.mttkrp_coo(jnp.asarray(t.indices),
                                        jnp.asarray(t.values),
                                        [jnp.asarray(f) for f in F], d, shape[d]))
        b = t_ref.mttkrp_coo(idx, vals, _t(F), d, shape[d]).numpy()
        np.testing.assert_allclose(b, a, **TOL)
        np.testing.assert_allclose(b, t_ref.mttkrp_dense(t, F, d), rtol=1e-4,
                                   atol=1e-4)
        others = [w for w in range(t.nmodes) if w != d]
        order = np.argsort(t.indices[:, d], kind="stable")
        ii, rows = t.indices[order][:, others], t.indices[order, d]
        a = np.asarray(r_ref.mttkrp_sorted_segments(
            jnp.asarray(ii), jnp.asarray(rows), jnp.asarray(t.values[order]),
            [jnp.asarray(F[w]) for w in others], shape[d]))
        b = t_ref.mttkrp_sorted_segments(
            torch.as_tensor(ii), torch.as_tensor(rows),
            torch.as_tensor(t.values[order]), _t([F[w] for w in others]),
            shape[d]).numpy()
        np.testing.assert_allclose(b, a, **TOL)
    mats = _factors((3, 4, 2), 3, seed=3)
    np.testing.assert_array_equal(t_ref.khatri_rao(mats), r_ref.khatri_rao(mats))


@pytest.mark.parametrize("shape,nnz,R,block_rows,tile", [
    ((64, 32, 16), 1000, 8, 16, 64),
    ((40, 7, 33, 5), 900, 16, 8, 32),
    ((16, 8, 4, 4, 4), 300, 4, 8, 16),
    ((257, 63, 5), 900, 33, 128, 256),
])
def test_plain_matches_pallas_interpret(shape, nnz, R, block_rows, tile):
    t = r_coo.random_sparse(shape, nnz, seed=4, distribution="powerlaw")
    F = _factors(shape, R, seed=5)
    plan = r_make_plan(t, kappa=4, block_rows=block_rows, tile=tile)
    for d in range(t.nmodes):
        packed = plan.packed(d)
        in_f = [F[w] for w in plan.layouts[d].input_modes()]
        np.testing.assert_allclose(_plain(packed, _t(in_f)),
                                   _pallas(packed, in_f), **TOL)


def test_plain_matches_pallas_rank_blocked():
    """The reference's rank-blocked kernel (rank 40 in blocks of 16, padded
    to 48) and the port's plain version compute the same function."""
    t = r_coo.random_sparse((96, 40, 24), 1500, seed=21, distribution="powerlaw")
    F = _factors(t.shape, 40, seed=22)
    plan = r_make_plan(t, kappa=4, block_rows=16, tile=64)
    for d in range(t.nmodes):
        packed = plan.packed(d)
        in_f = [F[w] for w in plan.layouts[d].input_modes()]
        np.testing.assert_allclose(_plain(packed, _t(in_f)),
                                   _pallas(packed, in_f, rank_block=16), **TOL)


def test_plain_bf16_matches_pallas_interpret():
    """bf16 factors accumulate in float32 in both: same rounded inputs,
    same products, float32 sums in another order."""
    t = r_coo.random_sparse((48, 24, 12), 700, seed=3)
    F = _factors(t.shape, 16, seed=4)
    plan = r_make_plan(t, kappa=2, block_rows=8, tile=32)
    for d in range(3):
        packed = plan.packed(d)
        in_f = [F[w] for w in plan.layouts[d].input_modes()]
        ref = np.asarray(mttkrp_pallas(
            jnp.asarray(packed.rb_of), jnp.asarray(packed.first),
            jnp.asarray(packed.idx_packed), jnp.asarray(packed.vals_packed),
            jnp.asarray(packed.lrows_packed),
            [jnp.asarray(f).astype(jnp.bfloat16) for f in in_f],
            num_row_blocks=packed.num_row_blocks, block_rows=packed.block_rows,
            tile=packed.tile, interpret=True))
        np.testing.assert_allclose(_plain(packed, _t(in_f, torch.bfloat16)),
                                   ref, **TOL)


def test_plain_empty_row_blocks_are_zero():
    idx = np.array([[0, 0, 0], [0, 1, 1], [63, 2, 2]], np.int32)
    vals = np.array([1.0, 2.0, 3.0], np.float32)
    t = r_coo.SparseTensor(idx, vals, (64, 3, 3))
    F = _factors(t.shape, 4, seed=10)
    plan = r_make_plan(t, kappa=1, block_rows=8, tile=8)
    packed = plan.packed(0)
    in_f = [F[w] for w in plan.layouts[0].input_modes()]
    out = _plain(packed, _t(in_f))
    np.testing.assert_allclose(out, _pallas(packed, in_f), **TOL)
    assert np.all(out[1:63] == 0)


@pytest.mark.parametrize("extra", [1, 37])
def test_plain_cap_slabs_add_exact_zero(extra):
    """Appended cap slabs change nothing, bit for bit."""
    t = random_sparse((40, 7, 33, 5), 900, seed=8)
    F = _factors(t.shape, 6, seed=9)
    plan = t_mttkrp.make_plan(t, 2, block_rows=8, tile=16, device="cpu")
    for d in range(t.nmodes):
        lay = plan.layouts[d]
        base = t_ops.pack_layout(lay, block_rows=8, tile=16)
        capped = t_ops.pack_layout(lay, block_rows=8, tile=16,
                                   num_slabs_cap=base.num_slabs + extra)
        in_f = _t([F[w] for w in lay.input_modes()])
        np.testing.assert_array_equal(_plain(capped, in_f), _plain(base, in_f))


@pytest.mark.parametrize("backend", ["slab", "segment", "coo"])
@pytest.mark.parametrize("kappa", [1, 4])
def test_front_door_matches_reference(backend, kappa):
    t = r_coo.random_sparse((40, 7, 33, 5), 1200, seed=12, distribution="powerlaw")
    F = _factors(t.shape, 8, seed=13)
    rplan = r_make_plan(t, kappa=kappa, block_rows=16, tile=64)
    tplan = t_mttkrp.make_plan(t, kappa, block_rows=16, tile=64, device="cpu")
    for d in range(t.nmodes):
        ref = np.asarray(r_mttkrp(rplan, [jnp.asarray(f) for f in F], d,
                                         backend="segment"))
        out = t_mttkrp.mttkrp(tplan, _t(F), d, backend=backend).numpy()
        np.testing.assert_allclose(out, ref, **TOL)


def test_packed_wrappers_match_reference():
    t = r_coo.random_sparse((50, 20, 10), 800, seed=14)
    F = _factors(t.shape, 12, seed=15)
    w = np.random.default_rng(2).random(t.nnz).astype(np.float32)
    rplan = r_make_plan(t, kappa=2, block_rows=8, tile=32)
    for d in range(t.nmodes):
        lay = rplan.layouts[d]
        in_f = [F[x] for x in lay.input_modes()]
        for weights in (None, w):
            rp = r_ops.pack_layout(lay, block_rows=8, tile=32, weights=weights)
            tp = t_ops.pack_layout(lay, block_rows=8, tile=32, weights=weights)
            ref = np.asarray(r_ops.mttkrp_packed(rp, [jnp.asarray(f) for f in in_f]))
            out = t_ops.mttkrp_packed(tp, _t(in_f)).numpy()
            oracle = t_ops.mttkrp_packed_ref(tp, _t(in_f)).numpy()
            np.testing.assert_allclose(out, ref, **TOL)
            np.testing.assert_allclose(oracle, ref, **TOL)


def test_cpu_wrapper_is_the_plain_version():
    t = r_coo.random_sparse((30, 20, 10), 600, seed=16)
    F = _factors(t.shape, 5, seed=17)
    packed = t_ops.pack_layout(t_mttkrp.make_plan(t, 1, device="cpu").layouts[0],
                               block_rows=8, tile=32)
    in_f = _t([F[1], F[2]])
    arrays = [torch.as_tensor(a) for a in (packed.idx_packed, packed.vals_packed,
                                           packed.lrows_packed, packed.rb_of)]
    before = dict(ks.LAUNCHES)
    out = ks.mttkrp_slab(*arrays, in_f, chunks=None,
                         num_row_blocks=packed.num_row_blocks,
                         block_rows=8, tile=32, rank_block=2)
    assert ks.LAUNCHES == before
    np.testing.assert_array_equal(out.numpy(), _plain(packed, in_f))


@pytest.mark.parametrize("chunk_slabs", [1, 3, 32])
def test_slab_chunks_tile_each_row_block(chunk_slabs):
    rb_of = np.array([0, 0, 0, 0, 0, 1, 2, 2, 2, 2, 2, 2, 2], np.int32)
    ch = ks.slab_chunks(rb_of, 3, "cpu", chunk_slabs)
    cs, ptr = ch.chunk_slab.numpy(), ch.rb_chunk_ptr.numpy()
    assert cs[0] == 0 and cs[-1] == len(rb_of) and np.all(np.diff(cs) >= 1)
    assert np.all(np.diff(cs) <= chunk_slabs)
    for b in range(3):
        for c in range(ptr[b], ptr[b + 1]):
            assert np.all(rb_of[cs[c]:cs[c + 1]] == b)
    # Appended cap slabs keep every real chunk boundary.
    capped = ks.slab_chunks(np.append(rb_of, [2] * 5).astype(np.int32), 3,
                            "cpu", chunk_slabs).chunk_slab.numpy()
    assert set(cs[:-1]) <= set(capped[:-1])
    with pytest.raises(ValueError):
        ks.slab_chunks(np.array([0, 2], np.int32), 3, "cpu")


def test_smem_sizing():
    assert ks.walkers_for(16) == 16 and ks.walkers_for(300) == 1
    rb = ks.max_rank_block(128, 232448)
    assert ks.smem_bytes(128, rb) <= 232448 < ks.smem_bytes(128, rb + 1)
