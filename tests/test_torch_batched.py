"""Port vs JAX package: the batched service on the CPU.

The port's ``BatchedEngine`` (slab backend: the batched kernel's plain
version on the CPU) against the reference's ``BatchedEngine(mesh=None)``
(segment backend) on the same bucket-mates and seeds, at the tolerances
of ``test_torch_cpd.py``.  The reference's pod path (``mesh=``) is not
used: it is broken under the installed jax (ROADMAP C-ref1).  Inside the
port, results that must not depend on batching are held bitwise: B = 1
vs B = n, padded vs unpadded, the batched plain version's lanes vs the
one-packing plain version, batched vs fused under the bucket's plan.
"""
import numpy as np
import pytest
import torch

from repro.core import random_sparse as r_random_sparse
from repro.core.als_device import init_state_host as r_init
from repro.serve import BatchedEngine as RBatchedEngine
from repro.serve import buckets as r_buckets
from repro_torch import methods
from repro_torch.convert import batch_from_reference, batch_to_host
from repro_torch.core.coo import random_sparse
from repro_torch.core.cpd import cpd_als
from repro_torch.core.layout import build_all_mode_layouts
from repro_torch.core.mttkrp import make_plan
from repro_torch.kernels import mttkrp_slab as ks
from repro_torch.kernels.ops import pack_layout
from repro_torch.serve import (BatchedEngine, Bucket, BucketPolicy,
                               batched_cache_stats, buckets)

FIT_ATOL = 1e-4
FACTOR_TOL = dict(rtol=1e-3, atol=1e-5)
BUCKETS = [((18, 13, 9), 500, 3), ((10, 8, 6, 5), 350, 4), ((30, 7, 5), 420, 5)]


def _stream(cls_random, shape, nnz, n=3):
    return [cls_random(shape, nnz - 13 * i, seed=i, distribution="powerlaw")
            for i in range(n)]


def _weights(ts):
    return [np.random.default_rng(20 + i).uniform(0.2, 1.6, t.nnz)
            .astype(np.float32) for i, t in enumerate(ts)]


def _bitwise(a, b):
    assert a.iters == b.iters
    for Fa, Fb in zip(a.factors, b.factors):
        assert np.array_equal(Fa, Fb)
    assert np.array_equal(a.weights, b.weights)


@pytest.mark.parametrize("method", ["cp", "nncp", "masked"])
@pytest.mark.parametrize("shape,nnz,R", BUCKETS)
def test_batched_matches_reference(shape, nnz, R, method):
    rts = _stream(r_random_sparse, shape, nnz)
    ts = _stream(random_sparse, shape, nnz)
    kw = dict(n_iters=4, tol=-1.0, seeds=[10, 11, 12], nnz_cap=nnz,
              method=method)
    if method == "masked":
        kw["weights"] = _weights(ts)
    ref = RBatchedEngine(rank=R, kappa=2, backend="segment",
                         check_every=2).decompose_batch(rts, **kw)
    got = BatchedEngine(R, kappa=2, check_every=2,
                        device="cpu").decompose_batch(ts, **kw)
    for g, r in zip(got, ref):
        assert g.engine == "batched" and g.method == method
        assert g.iters == r.iters and g.host_syncs == r.host_syncs == 3
        np.testing.assert_allclose(g.fits, r.fits, rtol=0, atol=FIT_ATOL)
        for Fg, Fr in zip(g.factors, r.factors):
            np.testing.assert_allclose(Fg, Fr, **FACTOR_TOL)


@pytest.mark.parametrize("backend", ["slab", "segment", "coo"])
@pytest.mark.parametrize("method", ["cp", "nncp", "masked"])
def test_b1_equals_bn_bitwise(method, backend):
    ts = _stream(random_sparse, (18, 13, 9), 500)
    eng = BatchedEngine(3, kappa=2, backend=backend, check_every=2,
                        device="cpu")
    kw = dict(n_iters=4, tol=-1.0, nnz_cap=512, method=method)
    ws = _weights(ts) if method == "masked" else [None] * 3
    b3 = eng.decompose_batch(ts, seeds=[4, 5, 6], weights=ws if
                             method == "masked" else None, **kw)
    for i, t in enumerate(ts):
        b1 = eng.decompose_batch([t], seeds=[4 + i], weights=[ws[i]] if
                                 method == "masked" else None, **kw)[0]
        _bitwise(b3[i], b1)
        np.testing.assert_allclose(b3[i].fits, b1.fits, rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["cp", "nncp"])
def test_padded_equals_unpadded_bitwise(method):
    """A request alone in its own cap and the same request under a larger
    bucket cap: plain and nncp pack unpadded under the plan's slab cap,
    whose appended slabs add exactly +0.0."""
    t = random_sparse((14, 11, 9), 200, seed=7, distribution="powerlaw")
    eng = BatchedEngine(3, kappa=2, check_every=2, device="cpu")
    kw = dict(n_iters=3, tol=-1.0, seeds=[1], method=method)
    exact = eng.decompose_batch([t], **kw)[0]
    padded = eng.decompose_batch([t], nnz_cap=1024, **kw)[0]
    _bitwise(exact, padded)
    assert exact.fits == padded.fits


@pytest.mark.parametrize("method", ["cp", "nncp", "masked"])
def test_batched_equals_fused_under_the_bucket_plan(method):
    """Each lane runs exactly the one-lane sweep, so a batched lane is
    bitwise the fused engine's run under the same bucket plan (masked:
    the fused run is on the unpadded tensor; its weight-0 padding changes
    no factor here)."""
    ts = _stream(random_sparse, (18, 13, 9), 500)
    ws = _weights(ts)
    eng = BatchedEngine(3, kappa=2, check_every=2, device="cpu")
    batch = eng.decompose_batch(
        ts, n_iters=4, tol=-1.0, seeds=[3, 4, 5], nnz_cap=512, method=method,
        weights=ws if method == "masked" else None)
    bplan = eng.bucket_plan((18, 13, 9), 512)
    for i, t in enumerate(ts):
        seq = cpd_als(t, 3, plan=make_plan(t, 2, partition=bplan, device="cpu"),
                      n_iters=4, tol=-1.0, check_every=2, seed=3 + i,
                      method=method, device="cpu",
                      weights=ws[i] if method == "masked" else None)
        if method == "masked":
            for Fb, Fs in zip(batch[i].factors, seq.factors):
                np.testing.assert_allclose(Fb, Fs, rtol=0, atol=1e-6)
        else:
            _bitwise(batch[i], seq)
        np.testing.assert_allclose(batch[i].fits, seq.fits, rtol=0, atol=1e-6)


def test_batched_plain_lane_equals_single_plain_bitwise():
    shape, R, cap = (40, 9, 7), 5, 1024
    ts = [random_sparse(shape, 900 - 70 * i, seed=i, distribution="powerlaw")
          for i in range(3)]
    eng = BatchedEngine(R, kappa=2, device="cpu")
    mp = eng.bucket_plan(shape, cap).modes[0]
    packs = [pack_layout(build_all_mode_layouts(t, 2)[0],
                         block_rows=mp.block_rows, tile=mp.tile,
                         num_slabs_cap=mp.slab_cap) for t in ts]
    rng = np.random.default_rng(0)
    facs = [torch.as_tensor(np.stack([rng.standard_normal((I, R)).astype(
        np.float32) for _ in ts])) for I in shape[1:]]

    def stacked(name):
        return torch.as_tensor(np.stack([getattr(p, name) for p in packs]))

    kw = dict(num_row_blocks=mp.num_row_blocks, block_rows=mp.block_rows,
              tile=mp.tile)
    out = ks.mttkrp_slab_batched_plain(
        stacked("idx_packed"), stacked("vals_packed"), stacked("lrows_packed"),
        stacked("rb_of"), facs, **kw)
    before = dict(ks.LAUNCHES)
    wrapped = ks.mttkrp_slab_batched(
        stacked("idx_packed"), stacked("vals_packed"), stacked("lrows_packed"),
        stacked("rb_of"), facs, chunks=None, **kw)
    assert ks.LAUNCHES == before and torch.equal(wrapped, out)
    for i, p in enumerate(packs):
        one = ks.mttkrp_slab_plain(
            *[torch.as_tensor(a) for a in (p.idx_packed, p.vals_packed,
                                           p.lrows_packed, p.rb_of)],
            [f[i] for f in facs], **kw)
        assert torch.equal(out[i], one)


def test_stacked_chunk_tables_pad_with_empty_chunks():
    rbs = [np.array([0, 0, 0, 1, 2, 2], np.int32),
           np.array([0, 1, 1, 1, 1, 2], np.int32)]
    ch = ks.stack_chunks(rbs, 3, "cpu", chunk_slabs=2)
    cs, ptr = ch.chunk_slab.numpy(), ch.rb_chunk_ptr.numpy()
    assert cs.shape == (2, ch.num_chunks + 1) and ptr.shape == (2, 4)
    for lane, rb in enumerate(rbs):
        one = ks.slab_chunks(rb, 3, "cpu", chunk_slabs=2)
        n = one.num_chunks
        assert np.array_equal(cs[lane, : n + 1], one.chunk_slab.numpy())
        assert np.all(cs[lane, n:] == len(rb))       # empty padding chunks
        assert np.array_equal(ptr[lane], one.rb_chunk_ptr.numpy())
    with pytest.raises(ValueError, match="slab count"):
        ks.stack_chunks([rbs[0], rbs[0][:-1]], 3, "cpu")


def test_iteration_caps_and_convergence_match_fused():
    """Per-request n_iters freeze a lane at its own budget, and tol > 0
    stops a lane at the sweep the fused engine stops at."""
    ts = _stream(random_sparse, (18, 13, 9), 480)
    eng = BatchedEngine(3, kappa=2, check_every=2, device="cpu")
    bplan = eng.bucket_plan((18, 13, 9), 480)
    batch = eng.decompose_batch(ts, n_iters=[2, 5, 3], tol=-1.0,
                                seeds=[0, 1, 2], nnz_cap=480)
    assert [r.iters for r in batch] == [2, 5, 3]
    assert [len(r.fits) for r in batch] == [2, 5, 3]
    for i, n in enumerate([2, 5, 3]):
        seq = cpd_als(ts[i], 3, plan=make_plan(ts[i], 2, partition=bplan,
                                               device="cpu"),
                      n_iters=n, tol=-1.0, check_every=2, seed=i, device="cpu")
        _bitwise(batch[i], seq)
    t = random_sparse((18, 13, 9), 480, seed=21, distribution="powerlaw")
    seq = cpd_als(t, 3, plan=make_plan(t, 2, partition=bplan, device="cpu"),
                  n_iters=20, tol=1e-3, check_every=2, seed=4, device="cpu")
    got = eng.decompose_batch([t, ts[0]], n_iters=20, tol=[1e-3, -1.0],
                              seeds=[4, 0], nnz_cap=480)
    assert got[0].iters == seq.iters < 20 and got[1].iters == 20
    np.testing.assert_allclose(got[0].fits, seq.fits, rtol=0, atol=1e-6)


def test_window_cache_reused_across_batches():
    eng = BatchedEngine(3, kappa=2, check_every=2, device="cpu")
    ts1 = _stream(random_sparse, (21, 11, 6), 300, n=2)
    ts2 = [random_sparse((21, 11, 6), 300 - 13 * i, seed=40 + i)
           for i in range(2)]
    eng.decompose_batch(ts1, n_iters=4, tol=-1.0, seeds=[0, 1], nnz_cap=320)
    before = batched_cache_stats()
    eng.decompose_batch(ts2, n_iters=4, tol=-1.0, seeds=[2, 3], nnz_cap=320)
    after = batched_cache_stats()
    assert after["currsize"] == before["currsize"]
    assert after["misses"] == before["misses"]
    assert after["hits"] > before["hits"]


def test_batch_quantum_repeats_the_last_request():
    ts = _stream(random_sparse, (18, 13, 9), 500)
    plain = BatchedEngine(3, kappa=2, check_every=2, device="cpu")
    quant = BatchedEngine(3, kappa=2, check_every=2, batch_quantum=4,
                          device="cpu")
    kw = dict(n_iters=3, tol=-1.0, seeds=[0, 1, 2], nnz_cap=512)
    a, b = plain.decompose_batch(ts, **kw), quant.decompose_batch(ts, **kw)
    assert len(b) == 3
    for x, y in zip(a, b):
        _bitwise(x, y)


def test_batch_rejects_bad_requests():
    eng = BatchedEngine(3, device="cpu")
    with pytest.raises(ValueError, match="mixes shapes"):
        eng.decompose_batch([random_sparse((10, 8, 6), 100, seed=0),
                             random_sparse((10, 8, 7), 100, seed=1)])
    t = random_sparse((10, 8, 6), 100, seed=0)
    with pytest.raises(ValueError, match="weighted-fit"):
        eng.decompose_batch([t], weights=[np.ones(100)])
    with pytest.raises(ValueError, match="exceeds"):
        eng.decompose_batch([t], nnz_cap=50, method="masked")
    with pytest.raises(ValueError, match="supports"):
        BatchedEngine(3, backend="pallas", device="cpu")
    spec = methods.register_method(methods.MethodSpec(
        name="_stateful_probe", stateful=True))
    try:
        assert "_stateful_probe" not in methods.batchable_methods()
        with pytest.raises(ValueError, match="stateful"):
            eng.decompose_batch([t], method=spec.name)
    finally:
        methods.registry._REGISTRY.pop(spec.name)


def test_empty_batch_and_zero_budget():
    eng = BatchedEngine(3, device="cpu")
    assert eng.decompose_batch([]) == []
    t = random_sparse((10, 8, 6), 120, seed=0)
    res = eng.decompose_batch([t], n_iters=0, tol=-1.0, seeds=[0])[0]
    assert res.iters == 0 and res.fits == []
    host = r_init((10, 8, 6), 3, 0)
    for F, G in zip(res.factors, host[0]):
        assert np.array_equal(F, G)


def test_every_bucket_mate_gets_one_plan():
    """``plan_bucket`` is a function of (shape, nnz cap, rank, kappa): every
    bucket-mate packs to the same slab cap and tiling, however its nnz
    falls over the rows."""
    shape, cap = (60, 9, 7), 1024
    eng = BatchedEngine(4, kappa=2, device="cpu")
    bplan = eng.bucket_plan(shape, cap)
    assert bplan is eng.bucket_plan(shape, cap)
    keys = set()
    for seed, (nnz, dist) in enumerate([(1024, "powerlaw"), (700, "uniform"),
                                        (129, "zipf")]):
        t = random_sparse(shape, nnz, seed=seed, distribution=dist)
        for d, lay in enumerate(build_all_mode_layouts(t, 2)):
            mp = bplan.modes[d]
            p = pack_layout(lay, block_rows=mp.block_rows, tile=mp.tile,
                            num_slabs_cap=mp.slab_cap)
            keys.add((d, p.num_slabs, p.block_rows, p.tile, p.num_row_blocks))
    assert len(keys) == len(shape)


def test_bucket_helpers_equal_reference():
    t = random_sparse((15, 11, 7), 200, seed=3)
    rt = r_random_sparse((15, 11, 7), 200, seed=3)
    for cap in (200, 256, 777):
        a, b = buckets.pad_tensor(t, cap), r_buckets.pad_tensor(rt, cap)
        assert a.indices.tobytes() == b.indices.tobytes()
        assert a.values.tobytes() == b.values.tobytes()
        w = np.linspace(0, 2, 200).astype(np.float32)
        assert (buckets.pad_weights(w, cap).tobytes()
                == r_buckets.pad_weights(w, cap).tobytes())
    with pytest.raises(ValueError):
        buckets.pad_tensor(t, 100)
    assert buckets.repeat_pad([1, 2], 5) == r_buckets.repeat_pad([1, 2], 5)
    for kw in ({}, {"mode": "geometric", "growth": 1.5, "min_cap": 64},
               {"quantum": 256, "min_cap": 256}):
        for nnz in (1, 64, 65, 200, 700, 1000):
            assert (BucketPolicy(**kw).nnz_cap(nnz)
                    == r_buckets.BucketPolicy(**kw).nnz_cap(nnz))
    pol, rpol = BucketPolicy.for_plan(256), r_buckets.BucketPolicy.for_plan(256)
    assert pol == BucketPolicy(quantum=256, min_cap=256)
    assert pol.bucket_for(t, "masked").key == rpol.bucket_for(rt, "masked").key
    assert Bucket((8, 8, 8), 768).padding_fraction(700) == pytest.approx(68 / 768)


def test_batch_state_round_trips_reference_layout():
    hosts = [r_init((9, 7, 5), 3, s) for s in range(3)]
    stacked = (tuple(np.stack([h[0][d] for h in hosts]) for d in range(3)),
               tuple(np.stack([h[1][d] for h in hosts]) for d in range(3)),
               np.stack([h[2] for h in hosts]))
    stacked = (tuple(stacked[0]), tuple(stacked[1]), stacked[2])
    states = batch_from_reference(*stacked, device="cpu")
    assert len(states) == 3
    back = batch_to_host(states)
    for a, b in zip(stacked[0] + stacked[1] + (stacked[2],),
                    back[0] + back[1] + (back[2],)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
