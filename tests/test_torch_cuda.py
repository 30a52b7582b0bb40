"""The port on the card: the CUDA kernel's three entries (value-baked,
valued, batched) against their plain versions, and the main path, the
methods and the batched service through the kernel.  Every test here carries the ``cuda``
marker and skips without a card.  The file imports nothing of JAX, so on
a machine with the card and without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The kernel's launch shape depends on the inputs (``launch_config``):
four columns per thread when the rank allows, one otherwise (rank 33);
small factors staged in shared memory, large ones gathered from device
memory.  The cases below cover each.

Tolerance: the kernel and ``index_add_`` sum the same float32 terms in
another order, so they may differ by a few ulps of each row's absolute
sum (``sum |val * prod F|``), more where terms cancel.  Outputs are held
to 1e-5 of the largest absolute sum, as ``chip_smoke.py`` does.
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.core.coo import random_sparse
from repro_torch.core.cpd import cpd_als
from repro_torch.core.layout import build_all_mode_layouts
from repro_torch.core.mttkrp import make_plan
from repro_torch.kernels import mttkrp_slab as ks
from repro_torch.kernels.ops import pack_layout
from repro_torch.serve import BatchedEngine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _factors(shape, R, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((I, R)).astype(np.float32),
                            device=device).to(dtype) for I in shape]


@pytest.mark.cuda
@pytest.mark.parametrize("R,rank_block,dtype", [
    (8, None, torch.float32), (33, 16, torch.float32),
    (16, None, torch.bfloat16)])
def test_kernel_matches_plain_on_card(cuda, R, rank_block, dtype):
    t = random_sparse((257, 63, 5, 9), 5000, seed=18, distribution="powerlaw")
    F = _factors(t.shape, R, 19, cuda, dtype)
    plan = make_plan(t, 4, block_rows=16, tile=64, device=cuda)
    for d in range(t.nmodes):
        idxp, valsp, lrowsp, rb_of, chunks, _ = plan.device_packed(d)
        in_f = [F[w] for w in plan.layouts[d].input_modes()]
        kw = dict(num_row_blocks=plan.packed(d).num_row_blocks,
                  block_rows=16, tile=64)
        before = ks.LAUNCHES["mttkrp_slab"]
        k = ks.mttkrp_slab(idxp, valsp, lrowsp, rb_of, in_f, chunks=chunks,
                           rank_block=rank_block, **kw)
        assert ks.LAUNCHES["mttkrp_slab"] == before + 1
        plain = ks.mttkrp_slab_plain(idxp, valsp, lrowsp, rb_of, in_f, **kw)
        mag = ks.mttkrp_slab_plain(idxp, valsp.abs(), lrowsp, rb_of,
                                   [f.abs() for f in in_f], **kw)
        torch.testing.assert_close(k, plain, rtol=0,
                                   atol=1e-5 * float(mag.max()))


@pytest.mark.cuda
def test_kernel_cap_slabs_are_exact_on_card(cuda):
    t = random_sparse((100, 40, 20), 3000, seed=5, distribution="powerlaw")
    F = _factors(t.shape, 8, 6, cuda)
    lay = make_plan(t, 2, device=cuda).layouts[0]
    in_f = [F[w] for w in lay.input_modes()]
    outs = []
    for cap in (None, 200):
        p = pack_layout(lay, block_rows=16, tile=32, num_slabs_cap=cap)
        arrays = [torch.as_tensor(a, device=cuda) for a in (
            p.idx_packed, p.vals_packed, p.lrows_packed, p.rb_of)]
        outs.append(ks.mttkrp_slab(
            *arrays, in_f, chunks=ks.slab_chunks(p.rb_of, p.num_row_blocks, cuda),
            num_row_blocks=p.num_row_blocks, block_rows=16, tile=32))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    t = random_sparse((30, 20, 10), 600, seed=1)
    plan = make_plan(t, 1, block_rows=8, tile=32, device=cuda)
    idxp, valsp, lrowsp, rb_of, chunks, _ = plan.device_packed(0)
    F = _factors(t.shape, 4, 2, cuda)
    kw = dict(chunks=chunks, num_row_blocks=plan.packed(0).num_row_blocks,
              block_rows=8, tile=32)
    with pytest.raises(TypeError):
        ks.mttkrp_slab(idxp, valsp.double(), lrowsp, rb_of, [F[1], F[2]], **kw)
    with pytest.raises(ValueError):
        ks.mttkrp_slab(idxp, valsp, lrowsp, rb_of, [F[1], F[2].cpu()], **kw)


@pytest.mark.cuda
def test_main_path_on_card_launches_the_kernel(cuda):
    t = random_sparse((40, 7, 33, 5), 1500, seed=0, distribution="powerlaw")
    before = ks.LAUNCHES["mttkrp_slab"]
    res = cpd_als(t, 5, backend="slab", n_iters=4, check_every=2, tol=-1.0)
    assert ks.LAUNCHES["mttkrp_slab"] - before == 4 * t.nmodes
    assert res.host_syncs == 3
    seg = cpd_als(t, 5, backend="segment", n_iters=4, check_every=2, tol=-1.0)
    np.testing.assert_allclose(res.fits, seg.fits, atol=1e-5)


@pytest.mark.cuda
def test_sweep_writes_no_nnz_by_rank_array_on_card(cuda):
    """The fit reads the last mode's MTTKRP, not the nonzeros: over a
    5-sweep call on 1,000,000 nonzeros at rank 32 the card's peak stays
    below the plan's packed copies plus one (nnz, R) float32 array
    (128 MB); a fit that gathers factor rows per nonzero writes several."""
    R = 32
    t = random_sparse((2000, 300, 100), 1_000_000, seed=21,
                      distribution="powerlaw")
    # The build and the window, on a plan of the call's own, so that the
    # measured call is the held plan's first: its sweeps run eagerly, then
    # are captured as graphs, and the peak covers both.
    cpd_als(t, R, n_iters=1, tol=-1.0)
    plan = make_plan(t, 1, device=cuda)
    packed = sum(a.nbytes for d in range(t.nmodes)
                 for a in plan.device_packed(d) if isinstance(a, torch.Tensor))
    torch.cuda.synchronize(cuda)
    others = torch.cuda.memory_allocated(cuda) - packed
    torch.cuda.reset_peak_memory_stats(cuda)
    res = cpd_als(t, R, plan=plan, n_iters=5, tol=-1.0)
    peak = torch.cuda.max_memory_allocated(cuda) - others
    assert res.iters == 5 and t.nnz == 1_000_000
    assert peak < packed + t.nnz * R * 4


@pytest.mark.cuda
@pytest.mark.parametrize("R,rank_block", [(8, None), (33, 16)])
def test_batched_lanes_equal_single_launches_on_card(cuda, R, rank_block):
    """Lane b of one batched launch is bitwise the single launch on lane
    b's packing, lanes of different chunk counts included."""
    shape, cap = (257, 63, 9), 6000
    ts = [random_sparse(shape, 6000 - 900 * i, seed=i, distribution="powerlaw")
          for i in range(4)]
    eng = BatchedEngine(R, kappa=2, device=cuda)
    bplan = eng.bucket_plan(shape, cap)
    F = [torch.stack(f) for f in zip(*[_factors(shape, R, 30 + i, cuda)
                                       for i in range(len(ts))])]
    for d in range(len(shape)):
        mp = bplan.modes[d]
        lay_d = [build_all_mode_layouts(t, 2)[d] for t in ts]
        packs = [pack_layout(lay, block_rows=mp.block_rows, tile=mp.tile,
                             num_slabs_cap=mp.slab_cap) for lay in lay_d]
        arr = [torch.as_tensor(np.stack([getattr(p, n) for p in packs]),
                               device=cuda)
               for n in ("idx_packed", "vals_packed", "lrows_packed", "rb_of")]
        in_f = [F[w] for w in lay_d[0].input_modes()]
        kw = dict(num_row_blocks=mp.num_row_blocks, block_rows=mp.block_rows,
                  tile=mp.tile, rank_block=rank_block)
        before = ks.LAUNCHES["mttkrp_slab_batched"]
        out = ks.mttkrp_slab_batched(
            *arr, in_f, chunks=ks.stack_chunks([p.rb_of for p in packs],
                                               mp.num_row_blocks, cuda), **kw)
        assert ks.LAUNCHES["mttkrp_slab_batched"] == before + 1
        for b, p in enumerate(packs):
            one = ks.mttkrp_slab(
                *[a[b] for a in arr], [f[b] for f in in_f],
                chunks=ks.slab_chunks(p.rb_of, p.num_row_blocks, cuda), **kw)
            assert torch.equal(out[b], one)


@pytest.mark.cuda
def test_valued_kernel_matches_plain_with_signed_zeros_on_card(cuda):
    """Run-time values with exact +0.0 and -0.0 residuals: the valued
    entry against its plain version, and bitwise against the value-baked
    launch on the same scattered values."""
    t = random_sparse((257, 63, 5, 9), 5000, seed=3, distribution="powerlaw")
    plan = make_plan(t, 4, block_rows=16, tile=64, device=cuda)
    F = _factors(t.shape, 16, 4, cuda)
    rng = np.random.default_rng(5)
    vals = rng.standard_normal(t.nnz).astype(np.float32)
    zero = rng.choice(t.nnz, size=400, replace=False)
    vals[zero[:200]] = 0.0
    vals[zero[200:]] = -0.0
    for d in range(t.nmodes):
        idxp, lrowsp, rb_of, chunks, _, perm, scatter = plan.device_structural(
            d, "slab")
        p = plan.packed(d)
        in_f = [F[w] for w in plan.layouts[d].input_modes()]
        kw = dict(num_row_blocks=p.num_row_blocks, block_rows=16, tile=64)
        v = torch.as_tensor(vals, device=cuda)[perm]
        before = ks.LAUNCHES["mttkrp_slab_valued"]
        k = ks.mttkrp_slab_valued(idxp, v, scatter, lrowsp, rb_of, in_f,
                                  chunks=chunks, **kw)
        assert ks.LAUNCHES["mttkrp_slab_valued"] == before + 1
        valsp = ks.scatter_slab_values(v, scatter, p.num_slabs * 64)
        baked = ks.mttkrp_slab(idxp, valsp, lrowsp, rb_of, in_f, chunks=chunks,
                               **kw)
        assert torch.equal(k, baked)
        plain = ks.mttkrp_slab_plain(idxp, valsp, lrowsp, rb_of, in_f, **kw)
        mag = ks.mttkrp_slab_plain(idxp, valsp.abs(), lrowsp, rb_of,
                                   [f.abs() for f in in_f], **kw)
        torch.testing.assert_close(k, plain, rtol=0,
                                   atol=1e-5 * float(mag.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cp", "nncp", "masked"])
def test_batched_service_on_card(cuda, method):
    """One batched launch per mode and sweep for the whole batch, and each
    lane equal to the fused engine's run under the bucket plan."""
    shape = (40, 7, 33, 5)
    ts = [random_sparse(shape, 1500 - 100 * i, seed=i, distribution="powerlaw")
          for i in range(3)]
    eng = BatchedEngine(5, kappa=2, check_every=2)
    before = ks.LAUNCHES["mttkrp_slab_batched"]
    batch = eng.decompose_batch(ts, n_iters=4, tol=-1.0, seeds=[0, 1, 2],
                                method=method)
    assert ks.LAUNCHES["mttkrp_slab_batched"] - before == 4 * len(shape)
    assert all(r.host_syncs == 3 for r in batch)
    bplan = eng.bucket_plan(shape, 1500)
    for i, t in enumerate(ts):
        seq = cpd_als(t, 5, plan=make_plan(t, 2, partition=bplan), n_iters=4,
                      check_every=2, tol=-1.0, seed=i, method=method)
        np.testing.assert_allclose(batch[i].fits, seq.fits, atol=1e-5)


def _close_to_plain(out, idxp, valsp, lrowsp, rb_of, in_f, **kw):
    plain = ks.mttkrp_slab_plain(idxp, valsp, lrowsp, rb_of, in_f, **kw)
    mag = ks.mttkrp_slab_plain(idxp, valsp.abs(), lrowsp, rb_of,
                               [f.abs() for f in in_f], **kw)
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-5 * float(mag.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("R,rank_block,dtype", [
    (16, None, torch.float32), (33, 16, torch.float32),
    (16, None, torch.bfloat16)])
def test_entries_with_staged_and_gathered_factors_on_card(cuda, R, rank_block, dtype):
    """Mode 0's inputs (20, 40, 9 rows) are all staged in shared memory;
    modes 1-3 gather the 3000-row factor (192 KB at rank 16, beyond the
    staging budget) from device memory and stage the rest.  Each entry
    against its plain version."""
    shape = (3000, 20, 40, 9)
    t = random_sparse(shape, 40000, seed=21, distribution="powerlaw")
    F = _factors(shape, R, 22, cuda, dtype)
    plan = make_plan(t, 2, block_rows=16, tile=64, device=cuda)
    rng = np.random.default_rng(23)
    resid = rng.standard_normal(t.nnz).astype(np.float32)
    for d in range(t.nmodes):
        p = plan.packed(d)
        in_modes = plan.layouts[d].input_modes()
        in_f = [F[w] for w in in_modes]
        rb = R if rank_block is None else rank_block
        mask = ks.launch_config(R, rb, 16, [shape[w] for w in in_modes],
                                smem_limit=ks.shared_memory_per_block(cuda)).staged_mask
        assert mask == (0b111 if d == 0 else 0b110)
        kw = dict(num_row_blocks=p.num_row_blocks, block_rows=16, tile=64)
        idxp, valsp, lrowsp, rb_of, chunks, _ = plan.device_packed(d)
        out = ks.mttkrp_slab(idxp, valsp, lrowsp, rb_of, in_f, chunks=chunks,
                             rank_block=rank_block, **kw)
        _close_to_plain(out, idxp, valsp, lrowsp, rb_of, in_f, **kw)
        _, _, _, _, _, perm, scatter = plan.device_structural(d, "slab")
        v = torch.as_tensor(resid, device=cuda)[perm]
        valued = ks.mttkrp_slab_valued(idxp, v, scatter, lrowsp, rb_of, in_f,
                                       chunks=chunks, rank_block=rank_block, **kw)
        vals_v = ks.scatter_slab_values(v, scatter, p.num_slabs * 64)
        _close_to_plain(valued, idxp, vals_v, lrowsp, rb_of, in_f, **kw)
        # Two lanes: the packing and the same packing with run-time values.
        lanes = [torch.stack([a, b]) for a, b in (
            (idxp, idxp), (valsp, vals_v), (lrowsp, lrowsp), (rb_of, rb_of))]
        bf = [torch.stack([f, f.flip(0)]) for f in in_f]
        out2 = ks.mttkrp_slab_batched(
            *lanes, bf, chunks=ks.stack_chunks([p.rb_of, p.rb_of],
                                               p.num_row_blocks, cuda),
            rank_block=rank_block, **kw)
        _close_to_plain(out2[0], idxp, valsp, lrowsp, rb_of, in_f, **kw)
        _close_to_plain(out2[1], idxp, vals_v, lrowsp, rb_of,
                        [f.flip(0) for f in in_f], **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1])
def test_many_chunks_capped_equals_uncapped_on_card(cuda, mode):
    """Mode 0 (100 rows) is one row block of hundreds of chunks, so pass
    two sums tens of groups; mode 1 (2000 rows) has 16 row blocks.  A
    slab-capped packing's appended zero slabs and chunks change no bit."""
    shape = (100, 2000, 300)
    t = random_sparse(shape, 300_000, seed=31, distribution="powerlaw")
    F = _factors(shape, 16, 32, cuda)
    lay = make_plan(t, 1, device=cuda).layouts[mode]
    in_f = [F[w] for w in lay.input_modes()]
    outs = []
    for cap in (None, 10_000):
        p = pack_layout(lay, block_rows=128, tile=32, num_slabs_cap=cap)
        arrays = [torch.as_tensor(a, device=cuda) for a in (
            p.idx_packed, p.vals_packed, p.lrows_packed, p.rb_of)]
        chunks = ks.slab_chunks(p.rb_of, p.num_row_blocks, cuda)
        kw = dict(num_row_blocks=p.num_row_blocks, block_rows=128, tile=32)
        outs.append(ks.mttkrp_slab(*arrays, in_f, chunks=chunks, **kw))
        _close_to_plain(outs[-1], *arrays, in_f, **kw)
    if mode == 0:
        assert p.num_row_blocks == 1 and chunks.num_chunks >= 200
    else:
        assert p.num_row_blocks == 16
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_unaligned_stream_and_factors_on_card(cuda):
    """A tile of 30 slots leaves the slot stream without 16-byte alignment,
    so the ring copies it 4 bytes at a time; factors at a 4-byte offset
    take one column per thread.  Both against the plain version, and a
    slab-capped packing bitwise equal to the uncapped one."""
    shape = (300, 40, 20)
    t = random_sparse(shape, 20000, seed=41, distribution="powerlaw")
    lay = make_plan(t, 1, device=cuda).layouts[0]
    rng = np.random.default_rng(42)
    in_f = []
    for w in lay.input_modes():
        flat = torch.empty(shape[w] * 16 + 1, device=cuda)[1:]   # 4-byte offset
        flat.copy_(torch.as_tensor(rng.standard_normal(shape[w] * 16).astype(np.float32)))
        in_f.append(flat.view(shape[w], 16))
    assert ks.launch_config(16, 16, 16, [f.shape[0] for f in in_f],
                            aligned=False).cols == 1
    outs = []
    for cap in (None, 2000):
        p = pack_layout(lay, block_rows=16, tile=30, num_slabs_cap=cap)
        arrays = [torch.as_tensor(a, device=cuda) for a in (
            p.idx_packed, p.vals_packed, p.lrows_packed, p.rb_of)]
        kw = dict(num_row_blocks=p.num_row_blocks, block_rows=16, tile=30)
        for factors in (in_f, [f.contiguous().clone() for f in in_f]):
            out = ks.mttkrp_slab(*arrays, factors, chunks=ks.slab_chunks(
                p.rb_of, p.num_row_blocks, cuda), **kw)
            _close_to_plain(out, *arrays, factors, **kw)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_double_buffered_service_equals_sync_on_card(cuda):
    """B = 8 per flush, two flushes: the double-buffered results (uploads on
    the copy stream, execution on the dispatch worker) are bitwise the
    synchronous ones, and every flush launches the batched entry once per
    mode and sweep."""
    from repro_torch.serve import BucketPolicy, DecompositionService

    ts = [random_sparse((40, 30, 20), 3600 - 37 * i, seed=i,
                        distribution="powerlaw") for i in range(16)]
    out = {}
    for db in (False, True):
        svc = DecompositionService(8, check_every=2, max_batch=8, max_wait_s=1e9,
                                   policy=BucketPolicy(mode="geometric"),
                                   double_buffer=db)
        before = dict(ks.LAUNCHES)
        futs = [svc.submit(t, n_iters=4, tol=-1.0, seed=i) for i, t in enumerate(ts)]
        svc.drain()
        out[db] = [f.result() for f in futs]
        snap = svc.snapshot()
        assert snap["batches"] == 2 and snap["flush_triggers"]["max_batch"] == 2
        assert ks.LAUNCHES["mttkrp_slab_batched"] - before["mttkrp_slab_batched"] == 2 * 4 * 3
        assert ks.LAUNCHES["mttkrp_slab"] == before["mttkrp_slab"]
    for a, b in zip(out[False], out[True]):
        assert a.fits == b.fits and a.host_syncs == b.host_syncs == 3
        for Fa, Fb in zip(a.factors, b.factors):
            assert np.array_equal(Fa, Fb)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cp", "masked"])
def test_slab_stream_increment_matches_segment_on_card(cuda, method):
    from repro_torch.core.coo import SparseTensor
    from repro_torch.methods import StreamingCP

    t = random_sparse((60, 40, 30), 6000, seed=5, distribution="powerlaw")
    w = np.random.default_rng(6).uniform(0.2, 1.0, t.nnz).astype(np.float32)
    wk = (lambda lo, hi: {"weights": w[lo:hi]} if method == "masked" else {})
    res = {}
    for backend in ("slab", "segment"):
        s = StreamingCP(8, method=method, backend=backend)
        s.start(SparseTensor(t.indices[:5000], t.values[:5000], t.shape),
                n_iters=4, tol=-1.0, seed=1, **wk(0, 5000))
        before = dict(ks.LAUNCHES)
        res[backend] = s.update(SparseTensor(t.indices[5000:], t.values[5000:],
                                             t.shape), **wk(5000, 6000))
        entry = "mttkrp_slab_valued" if method == "masked" else "mttkrp_slab"
        launched = ks.LAUNCHES[entry] - before[entry]
        assert launched == (2 * 3 if backend == "slab" else 0)
    gap = max(abs(a - b) for a, b in zip(res["slab"].fits, res["segment"].fits))
    assert gap <= 1e-5


@pytest.mark.cuda
def test_checkpoint_saves_on_card_and_restores_onto_card(cuda, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.coo import SparseTensor
    from repro_torch.methods import StreamingCP

    F = _factors((7, 5), 4, 3, cuda)
    m = CheckpointManager(tmp_path / "tree", async_save=False)
    m.save(1, {"F": F, "lam": torch.ones(4, device=cuda)})
    out, _ = m.restore(template={"F": F, "lam": torch.ones(4, device=cuda)})
    assert all(a.device == cuda and torch.equal(a, b) for a, b in zip(out["F"], F))
    out, _ = m.restore(template={"F": [f.cpu() for f in F], "lam": torch.ones(4)})
    assert out["lam"].device.type == "cpu" and torch.equal(out["F"][0], F[0].cpu())

    t = random_sparse((30, 20, 10), 2000, seed=9, distribution="powerlaw")
    s1 = StreamingCP(4)
    s1.start(SparseTensor(t.indices[:1500], t.values[:1500], t.shape), n_iters=4,
             tol=-1.0)
    s1.save(tmp_path / "sess")
    s2 = StreamingCP.restore(tmp_path / "sess")
    assert s2.device.type == "cuda"
    delta = SparseTensor(t.indices[1500:], t.values[1500:], t.shape)
    r1, r2 = s1.update(delta), s2.update(delta)
    assert abs(r1.fits[-1] - r2.fits[-1]) <= 1e-6


@pytest.mark.cuda
def test_slab_branch_with_a_mesh_on_card(cuda):
    """B1e on a mesh of one rank: this rank's packed shard through the
    kernel, the (identity) sum, the unrelabel: within 1e-5 of the
    single-device slab MTTKRP, and one window of the distributed slab
    sweep launches the kernel once per mode and sweep."""
    from repro_torch.core import als_device
    from repro_torch.core.distributed import (_collect_dist_data,
                                              make_distributed_plan,
                                              shard_slab_mode_data)
    from repro_torch.core.mttkrp import mttkrp
    from repro_torch.launch import make_mesh

    t = random_sparse((300, 24, 7), 20_000, seed=4, distribution="powerlaw")
    mesh = make_mesh((1,), ("sm",), device=cuda)
    plan = make_distributed_plan(t, mesh)
    md, meta = shard_slab_mode_data(plan, 8)
    F = _factors(t.shape, 8, 12, cuda)
    ctx = als_device.make_sweep_context("slab", 3, 8, t.shape, meta, "cho",
                                        axis=mesh)
    single = make_plan(t, 1, device=cuda)
    for d in range(3):
        got = ctx.one_mttkrp(d, md[d], [F], None)[0]
        ref = mttkrp(single, F, d, backend="slab")
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().sum())
    window = als_device._build_sweep_block("slab", 3, 8, t.shape, meta, "cho",
                                           2, "cp", mesh)
    _, fit_data = _collect_dist_data(plan)
    before = ks.LAUNCHES["mttkrp_slab"]
    _, fits, ok = window(als_device.init_state(t.shape, 8, 0, device=cuda),
                         md, fit_data)
    assert ks.LAUNCHES["mttkrp_slab"] - before == 2 * 3
    assert bool(ok) and bool(torch.isfinite(fits).all())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["cp", "masked"])
def test_pod_of_one_rank_equals_batched_on_card(cuda, method):
    from repro_torch.launch import make_batch_mesh

    ts = [random_sparse((40, 30, 20), 3000 - 50 * i, seed=i,
                        distribution="powerlaw") for i in range(3)]
    kw = dict(n_iters=4, tol=-1.0, seeds=[1, 2, 3], nnz_cap=3000, method=method)
    if method == "masked":
        kw["weights"] = [np.random.default_rng(i).uniform(0.2, 1.0, t.nnz)
                         .astype(np.float32) for i, t in enumerate(ts)]
    ref = BatchedEngine(6, check_every=2, device=cuda).decompose_batch(ts, **kw)
    before = ks.LAUNCHES["mttkrp_slab_batched"]
    pod = BatchedEngine(6, check_every=2, mesh=make_batch_mesh(1, device=cuda),
                        batch_quantum=2).decompose_batch(ts, **kw)
    assert ks.LAUNCHES["mttkrp_slab_batched"] - before == 4 * 3
    for a, b in zip(pod, ref):
        assert a.engine == "pod" and a.host_syncs == 1
        assert a.fits == b.fits
        for Fa, Fb in zip(a.factors, b.factors):
            assert np.array_equal(Fa, Fb)


@pytest.mark.cuda
def test_factorized_embedding_gradient_on_card(cuda):
    """B1f: the embedding gradient's mode-0 and mode-1 MTTKRP through the
    kernel, two launches, against the segment backend on the CPU."""
    from repro_torch.models import factorized_embed as fe

    V, d, R = 500, 16, 32
    rng = np.random.default_rng(3)
    p = {k: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
         for k, s in (("A", (23, R)), ("B", (22, R)), ("C", (d, R)))}
    toks = torch.as_tensor(rng.integers(0, V, (4, 64)))
    dY = torch.as_tensor(rng.standard_normal((4, 64, d)).astype(np.float32))
    ref = fe.grad_factors_mttkrp(p, toks, dY, V, backend="segment")
    before = ks.LAUNCHES["mttkrp_slab"]
    got = fe.grad_factors_mttkrp({k: v.to(cuda) for k, v in p.items()}, toks.to(cuda),
                                 dY.to(cuda), V)
    assert ks.LAUNCHES["mttkrp_slab"] - before == 2
    for g, r in zip(got, ref):
        assert float((g.cpu() - r).abs().max()) <= 1e-5 * float(r.abs().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("kappa", [1, 4])
def test_plan_made_on_card_is_the_cpu_plan(cuda, kappa):
    """Planning on the card: about 1,000,000 nonzeros sorted and packed
    there give the bytes the same code gives on the CPU (which the CPU
    tests hold to the JAX package's host plan): every copy's ordering and
    row maps, every packing, the value scatter.  The card plan keeps its
    packed arrays as the device data; on chicago's shape and nonzero count
    (kappa 1) planning's peak allocation stays under a call's."""
    t = random_sparse((6186, 24, 77, 32), 1_000_000, seed=40 + kappa,
                      distribution="powerlaw")
    card = make_plan(t, kappa, device=cuda)
    host = make_plan(t, kappa, device="cpu")
    for d in range(t.nmodes):
        a, b = card.packed(d), host.packed(d)
        assert a.device == cuda and b.device.type == "cpu"
        for name in ("idx_packed", "vals_packed", "lrows_packed", "rb_of",
                     "first", "val_scatter"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), (d, name)
        la, lb = card.layouts[d], host.layouts[d]
        for name in ("perm", "row_perm", "row_ptr", "part_offsets"):
            assert np.array_equal(getattr(la, name), getattr(lb, name)), name
        assert card.device_packed(d)[0].data_ptr() == a.slots[
            "idx_packed"].data_ptr()
    assert card._source is None
    if kappa != 1:
        return
    R = 32
    big = random_sparse((6186, 24, 77, 32), 5_330_673, seed=44,
                        distribution="powerlaw")
    del card
    # A call before the base, so that the base holds the BLAS workspace
    # of the card's stream, which the measured call uses.  Garbage of
    # earlier tests collected now, not freed below the base in mid-call.
    cpd_als(t, R, n_iters=1, tol=0.0)
    gc.collect()
    torch.cuda.synchronize(cuda)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    plan = make_plan(big, 1, device=cuda)
    for d in range(big.nmodes):
        plan.device_packed(d)
    torch.cuda.synchronize(cuda)
    planning = torch.cuda.max_memory_allocated(cuda) - base
    # What stays is what the plan counts, in the allocator's blocks (a
    # large array's block may take up to 1 MB of its segment's rest).
    held = torch.cuda.memory_allocated(cuda) - base
    assert plan.device_bytes <= held <= 1.02 * plan.device_bytes, (
        held, plan.device_bytes)
    torch.cuda.synchronize(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    # The plan's first call: eager sweeps, then the capture of its graphs
    # (the peak of a held plan's calls; its replays allocate less).
    cpd_als(big, R, plan=plan, n_iters=5, check_every=5, tol=0.0)
    torch.cuda.synchronize(cuda)
    call = torch.cuda.max_memory_allocated(cuda) - base
    assert planning < call, (planning, call)


@pytest.mark.cuda
def test_fit_data_uploads_from_the_plans_page_locked_copy(cuda):
    """A call through a plan of its tensor uploads its fit data from the
    plan's page-locked copy: the same bytes, counted the same."""
    from repro_torch.core import als_device

    t = random_sparse((300, 40, 20), 20_000, seed=45, distribution="powerlaw")
    plan = make_plan(t, 1, device=cuda)
    staged = plan.staged_fit_data()
    assert staged[0].is_pinned() and staged[1].is_pinned()
    assert plan.staged_fit_data() is staged
    a = als_device.make_fit_data(t, cuda)
    b = als_device.make_fit_data(t, cuda, staged)
    for x, y in zip(a[0] + a[1:], b[0] + b[1:]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    state = als_device.init_state_host(t.shape, 4, seed=2)
    res = cpd_als(t, 4, plan=plan, n_iters=2, init_state=state)
    state_bytes = sum(np.asarray(a).nbytes for part in state[:2]
                      for a in part) + state[2].nbytes
    fit_bytes = t.indices.nbytes + t.nnz * 4 + 4
    assert res.h2d_bytes == state_bytes + fit_bytes


def _graph_case(cuda):
    t = random_sparse((300, 40, 120, 9), 30_000, seed=50,
                      distribution="powerlaw")
    return t, make_plan(t, 1, device=cuda)


def _assert_close_results(got, want):
    """Fits to 1e-6 and factors and weights to 1e-5, relative."""
    np.testing.assert_allclose(got.fits, want.fits, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-5, atol=0)
    for a, b in zip(got.factors, want.factors):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("method,backend", [
    ("cp", "slab"), ("nncp", "slab"), ("cp", "segment")])
def test_replayed_sweeps_equal_eager_sweeps_on_card(cuda, method, backend):
    """A held plan's first call runs its 7 sweeps eagerly, captures the
    sweep (one slab call per mode, counted as a capture) and replays it
    once, which launches the kernel once per mode; later calls replay it,
    count the replayed launches and equal the eager calls (no plan) from
    the same starts, with the same host reads.  Two calls in a row from other
    starts catch a static buffer not refreshed or a fit not copied out.
    On an H100 the replayed and eager results of the slab backend came
    out bitwise equal (cp and nncp, ranks 8 and 32); the segment
    backend's ``index_add_`` sums in no fixed order on either path."""
    from repro_torch.core import als_device

    t, plan = _graph_case(cuda)
    kw = dict(n_iters=7, check_every=3, tol=-1.0, method=method,
              backend=backend)
    slab = backend == "slab"
    before = ks.LAUNCHES["mttkrp_slab"], ks.CAPTURES["mttkrp_slab"]
    first = cpd_als(t, 8, plan=plan, seed=1, **kw)
    assert first.graph_sweeps == 0
    assert (ks.LAUNCHES["mttkrp_slab"] - before[0],
            ks.CAPTURES["mttkrp_slab"] - before[1]) == (
        (8 * t.nmodes, t.nmodes) if slab else (0, 0))
    for seed in (2, 3):
        start = als_device.init_state_host(t.shape, 8, seed)
        if method == "nncp":
            start = als_device.state_from_factors(
                [np.abs(F) + 0.01 for F in start[0]])
        eager = cpd_als(t, 8, init_state=start, **kw)
        before = ks.LAUNCHES["mttkrp_slab"], ks.CAPTURES["mttkrp_slab"]
        replayed = cpd_als(t, 8, plan=plan, init_state=start, **kw)
        assert (ks.LAUNCHES["mttkrp_slab"] - before[0],
                ks.CAPTURES["mttkrp_slab"] - before[1]) == (
            (7 * t.nmodes, 0) if slab else (0, 0))
        assert replayed.graph_sweeps == replayed.iters == 7
        assert replayed.host_syncs == eager.host_syncs == 4
        if slab:
            _assert_close_results(replayed, eager)
        else:   # as the main path's slab and segment fits are held
            np.testing.assert_allclose(replayed.fits, eager.fits, atol=1e-5)


@pytest.mark.cuda
def test_failed_window_reruns_eagerly_on_card(cuda):
    """A gram that is not positive definite fails the first window's
    Cholesky on the graph path: the window reruns eagerly from its start
    with the rescue and the call equals the eager call."""
    from repro_torch.core import als_device

    t, plan = _graph_case(cuda)
    kw = dict(n_iters=6, check_every=3, tol=-1.0)
    cpd_als(t, 8, plan=plan, **kw)
    factors, grams, weights = als_device.init_state_host(t.shape, 8, 5)
    grams = list(grams)
    grams[1] = -np.eye(8, dtype=np.float32)
    start = (factors, tuple(grams), weights)
    eager = cpd_als(t, 8, init_state=start, **kw)
    replayed = cpd_als(t, 8, plan=plan, init_state=start, **kw)
    assert eager.host_syncs == replayed.host_syncs == 4
    assert replayed.graph_sweeps == 3
    _assert_close_results(replayed, eager)


@pytest.mark.cuda
def test_replayed_spans_hold_their_kernels_on_card(cuda):
    """Under ``torch.profiler`` each replay runs inside its span: the
    kernels of the replayed graphs count in the spans' device time, as
    the eager launches do."""
    from torch.profiler import ProfilerActivity, profile

    t, plan = _graph_case(cuda)
    cpd_als(t, 8, plan=plan, n_iters=4, check_every=2, tol=-1.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = cpd_als(t, 8, plan=plan, n_iters=4, check_every=2, tol=-1.0)
        torch.cuda.synchronize(cuda)
    assert res.graph_sweeps == 4
    device, count = {}, {}
    for e in prof.events():
        if e.name in ("als.mttkrp", "als.update", "als.fit"):
            device[e.name] = device.get(e.name, 0) + e.device_time_total
            count[e.name] = count.get(e.name, 0) + 1
    assert count == {"als.mttkrp": 4 * t.nmodes, "als.update": 4 * t.nmodes,
                     "als.fit": 4}
    assert all(v > 0 for v in device.values()), device


@pytest.mark.cuda
def test_dropping_the_plan_frees_its_graphs_on_card(cuda):
    """The graphs live on the plan: once the plan goes, the card holds what
    it held before the plan (the BLAS workspaces dropped first, since a
    capture drops them), and the pool that ``graph_pool_bytes`` counts,
    reserved and not allocated while the plan lives, goes back."""
    torch.cuda.synchronize(cuda)
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    level = torch.cuda.memory_allocated(cuda)
    t, plan = _graph_case(cuda)
    for _ in range(2):
        res = cpd_als(t, 8, plan=plan, n_iters=4, check_every=2, tol=-1.0)
    assert res.graph_sweeps == 4 and len(plan._graphs) == 1
    torch.cuda.synchronize(cuda)
    assert torch.cuda.memory_allocated(cuda) > level
    pool = plan.graph_pool_bytes
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(cuda)
    assert 0 < pool <= reserved
    del plan, res
    gc.collect()
    torch.cuda.synchronize(cuda)
    torch._C._cuda_clearCublasWorkspaces()
    assert torch.cuda.memory_allocated(cuda) == level
    torch.cuda.empty_cache()
    assert reserved - torch.cuda.memory_reserved(cuda) >= pool
