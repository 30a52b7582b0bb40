"""Port vs JAX package: the MTTKRP oracles, the slab kernel's plain version
and the MTTKRP front door.

Tolerances: rtol 1e-5 / atol 1e-5 wherever the two packages sum the same
float32 terms in another order (``index_add_`` vs ``segment_sum`` vs the
Pallas kernel's one-hot matmuls).  Results that must be exact (cap slabs
adding +0.0, the CPU wrapper being the plain version) are compared
bitwise.  The card's
cases are in ``test_torch_cuda.py``.
"""
import importlib

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
from repro_torch.core.coo import random_sparse
from repro_torch.kernels import mttkrp_slab as ks
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

# ``repro_torch.core`` exports the function ``mttkrp`` under the module's name.
t_mttkrp = importlib.import_module("repro_torch.core.mttkrp")

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
    # One column per thread (a rank block that is no multiple of 4): a
    # walker is rank_block threads.  Four columns per thread: a quarter of
    # that, and at most MAX_WALKERS walkers.
    assert ks.walkers_for(16, cols=1) == 16 and ks.walkers_for(300, cols=1) == 1
    assert ks.walkers_for(16) == 64 and ks.walkers_for(300) == 3
    assert ks.walkers_for(4) == ks.MAX_WALKERS and ks.walkers_for(33) == 7
    rb = ks.max_rank_block(128, 232448)
    assert ks.smem_bytes(128, rb) <= 232448 < ks.smem_bytes(128, rb + 1)
    # The ring, tile and carries at rank block 16 (64 walkers of 8 slots
    # per stage) for 3 input factors: 2*5*64*8 + 128*16 + 64*16 + 64 words.
    assert ks.stage_slots_for(64) == 8 and ks.stage_slots_for(16) == 32
    assert ks.smem_bytes(128, 16, num_inputs=3) == 4 * (5120 + 2048 + 1024 + 64)
    # Fewer inputs leave room for a wider rank block.
    assert (ks.max_rank_block(128, 48 * 1024, 2)
            > ks.max_rank_block(128, 48 * 1024, 3)
            > ks.max_rank_block(128, 48 * 1024))


def test_staged_inputs_smallest_first_within_budget():
    # Chicago mode 1 at rank 16: the two small inputs fit, the 24,744-row
    # factor (1.58 MB) does not.
    assert ks.staged_inputs([24744, 77, 32], 16) == 0b110
    assert ks.staged_inputs([24, 77, 32], 16) == 0b111
    assert ks.staged_inputs([24, 77, 32], 16, budget=0) == 0
    # Smallest first, ties by position: equal sizes stage the earlier one.
    assert ks.staged_inputs([100, 100], 8, budget=100 * 8 * 4) == 0b01
    rng = np.random.default_rng(0)
    for _ in range(200):
        rows = rng.integers(1, 3000, size=rng.integers(1, ks.MAX_INPUTS + 1))
        rb = int(rng.choice([4, 8, 16, 33]))
        budget = int(rng.integers(0, 64 * 1024))
        mask = ks.staged_inputs(list(rows), rb, budget)
        assert mask == ks.staged_inputs(list(rows), rb, budget)
        staged = [w for w in range(len(rows)) if mask >> w & 1]
        rest = [w for w in range(len(rows)) if not mask >> w & 1]
        assert sum(int(rows[w]) * rb * 4 for w in staged) <= budget
        if staged and rest:
            assert max(rows[w] for w in staged) <= min(rows[w] for w in rest)
        if rest:   # the smallest input left out would overflow the budget
            nxt = min(rest, key=lambda w: (rows[w], w))
            assert (sum(int(rows[w]) * rb * 4 for w in staged)
                    + int(rows[nxt]) * rb * 4 > budget)


@pytest.mark.parametrize("rank,rank_block,rows,aligned,cols,walkers,mask", [
    (16, 16, [24, 77, 32], True, 4, 64, 0b111),        # chicago mode 0
    (16, 16, [24744, 77, 32], True, 4, 64, 0b110),     # chicago mode 1
    (33, 16, [24744, 77, 32], True, 1, 16, 0b110),     # rank 33: narrow
    (16, 16, [24744, 77, 32], False, 1, 16, 0b110),    # unaligned factors
    (8, 8, [30, 20], True, 4, 64, 0b11),
    (16, 16, [183, 1140, 1717], True, 4, 64, 0b001),   # uber mode 1
])
def test_launch_config(rank, rank_block, rows, aligned, cols, walkers, mask):
    limit = 232448
    cfg = ks.launch_config(rank, rank_block, 128, rows, aligned=aligned,
                           smem_limit=limit)
    assert (cfg.cols, cfg.walkers, cfg.staged_mask) == (cols, walkers, mask)
    assert cfg.threads == walkers * rank_block // cols <= ks.MAX_THREADS
    staged = sum(r * rank_block * 4 for w, r in enumerate(rows) if mask >> w & 1)
    assert cfg.smem == ks.smem_bytes(128, rank_block, cols, len(rows)) + staged
    assert staged <= ks.STAGED_FACTOR_BYTES and cfg.smem <= limit
    assert cfg.stage_slots % 4 == 0 and cfg.walkers * cfg.stage_slots <= ks.STAGE_SLOTS
    # A block limit with no room beyond the ring, tile and carries stages
    # nothing.
    tight = ks.launch_config(rank, rank_block, 128, rows, aligned=aligned,
                             smem_limit=ks.smem_bytes(128, rank_block, cols, len(rows)))
    assert tight.staged_mask == 0


@pytest.mark.parametrize("slabs_per_rb", [[5, 1, 7], [700, 3], [1, 1, 1, 1]])
def test_group_tables_tile_each_row_block(slabs_per_rb):
    rb_of = np.repeat(np.arange(len(slabs_per_rb)), slabs_per_rb).astype(np.int32)
    nrb = len(slabs_per_rb)
    ch = ks.slab_chunks(rb_of, nrb, "cpu", chunk_slabs=2)
    cptr, gc, gptr = (t.numpy() for t in (ch.rb_chunk_ptr, ch.group_chunk,
                                          ch.rb_group_ptr))
    assert gc[0] == 0 and gc[-1] == ch.num_chunks and np.all(np.diff(gc) >= 1)
    assert np.all(np.diff(gc) <= ks.GROUP_CHUNKS)
    for b in range(nrb):
        # Row block b's groups cover exactly its chunks, in order, and
        # start at its first chunk.
        starts = gc[gptr[b]:gptr[b + 1]]
        assert starts[0] == cptr[b] and gc[gptr[b + 1]] == cptr[b + 1]
        assert np.all((starts - cptr[b]) % ks.GROUP_CHUNKS == 0)
    # Appended cap slabs keep every real group boundary.
    capped = ks.slab_chunks(np.append(rb_of, [nrb - 1] * 97).astype(np.int32),
                            nrb, "cpu", chunk_slabs=2)
    assert set(gc[:-1]) <= set(capped.group_chunk.numpy()[:-1])
    assert ch.numel() == sum(len(t) for t in (cptr, gc, gptr)) + ch.num_chunks + 1


def test_stack_chunks_pads_with_empty_chunks_and_groups():
    lanes = [np.repeat([0, 1], [600, 4]).astype(np.int32),
             np.repeat([0, 1], [3, 601]).astype(np.int32),
             np.repeat([0, 1], [302, 302]).astype(np.int32)]
    st = ks.stack_chunks(lanes, 2, "cpu", chunk_slabs=8)
    for b, rb_of in enumerate(lanes):
        one = ks.slab_chunks(rb_of, 2, "cpu", chunk_slabs=8)
        for name in ("chunk_slab", "group_chunk"):
            own = getattr(one, name).numpy()
            row = getattr(st, name)[b].numpy()
            np.testing.assert_array_equal(row[:len(own)], own)
            assert np.all(row[len(own):] == own[-1])   # empty padding
        for name in ("rb_chunk_ptr", "rb_group_ptr"):
            np.testing.assert_array_equal(getattr(st, name)[b].numpy(),
                                          getattr(one, name).numpy())


def test_library_hash_covers_headers(tmp_path):
    from repro_torch.kernels import build

    src = tmp_path / "k.cu"
    src.write_text("// kernel")
    (tmp_path / "common.cuh").write_text("// header")
    (tmp_path / "notes.txt").write_text("not a source")
    assert build.library_sources(src) == [src, tmp_path / "common.cuh"]
    first = build.library_path(src)
    (tmp_path / "notes.txt").write_text("edited")
    assert build.library_path(src) == first
    (tmp_path / "common.cuh").write_text("// edited header")
    assert build.library_path(src) != first


def test_ptxas_summary_names_each_instance():
    from repro_torch.kernels import build

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__a2_14_mttkrp_slab_cu_6"
        "18chunk_tiles_kernelIfLi3ELi4EEEvNS_8SlabArgsE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN18chunk_tiles_kernelIfLi3ELi4EEEv",
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 8 bytes cumulative stack size",
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__a2_14_mttkrp_slab_cu_6"
        "18chunk_tiles_kernelI13__nv_bfloat16Li2ELi1EEEvNS_8SlabArgsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__a2_14_mttkrp_slab_cu_6"
        "17sum_ranges_kernelEPKiiPKfiPfi' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers",
    ])
    assert build.ptxas_summary(log) == [
        "chunk_tiles_kernel<float,W=3,V=4>: 64 registers, "
        "12 bytes spill stores, 16 bytes spill loads",
        "chunk_tiles_kernel<bfloat16,W=2,V=1>: 56 registers, "
        "0 bytes spill stores, 0 bytes spill loads",
        "sum_ranges_kernel: 32 registers, 0 bytes spill stores, 0 bytes spill loads",
    ]
