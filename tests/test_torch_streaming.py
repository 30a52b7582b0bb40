"""Port vs JAX package: streaming sessions on the CPU.

Host stages are held bitwise against the reference: ``_canonical``,
``_merge_sorted`` (against the reference's merge itself, not against
concat + ``_canonical``: with a coordinate repeated within one side the
two differ by design), ``session_cap``, the session's coordinates,
values and weights after a stream, and eviction survivors.  Fits and
factors of ``StreamingCP`` (cp, nncp, masked; the port on its slab
kernel's plain version and on segment) are held against the reference's
``StreamingCP(backend="segment")`` at the tolerances of
``test_torch_methods.py``.  The port's own invariants: bucket padding is
bitwise a no-op on segment and within 1e-5 on slab, a restored session
continues as the uninterrupted one, and an increment inside its bucket
adds no miss to the window-function cache.
"""
import numpy as np
import pytest

from repro.core import SparseTensor as RSparseTensor
from repro.core.plan import session_cap as r_session_cap
from repro.methods import StreamingCP as RStreamingCP
from repro.methods.streaming import _canonical as r_canonical
from repro.methods.streaming import _merge_sorted as r_merge_sorted
from repro.serve.buckets import BucketPolicy as RBucketPolicy
from repro_torch.convert import stream_state_from_reference
from repro_torch.core.als_device import sweep_cache_stats
from repro_torch.core.coo import SparseTensor, random_sparse
from repro_torch.core.cpd import cpd_als
from repro_torch.core.plan import session_cap
from repro_torch.methods import StreamingCP, batchable_methods, get_method
from repro_torch.methods.streaming import _canonical, _merge_sorted
from repro_torch.obs import trace
from repro_torch.runtime import ALSRunner
from repro_torch.serve import BucketPolicy

FIT_ATOL = 1e-4
FACTOR_TOL = dict(rtol=1e-3, atol=1e-5)
SHAPE = (10, 8, 6)
SMALL = (4, 3, 3)          # few coordinates: repeats within one side


def _rand_coo(n, seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, n) for s in shape],
                   axis=1).astype(np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    return idx, vals


def _stream_data(method, seed=3):
    """A 130-entry tensor split 70 / 35 / 25, with confidences for masked."""
    t = random_sparse(SHAPE, 130, seed=seed, distribution="powerlaw")
    vals = np.abs(t.values) + 0.1 if method == "nncp" else t.values
    w = (np.random.default_rng(seed + 10).uniform(0.3, 1.0, t.nnz)
         .astype(np.float32) if method == "masked" else None)
    return t.indices, vals.astype(np.float32), w


SPLITS = ((0, 70), (70, 105), (105, 130))


def _drive(cls, tensor_cls, method, idx, vals, w, **kw):
    s = cls(3, method=method, refine_iters=2, check_every=2, **kw)
    results = []
    for i, (lo, hi) in enumerate(SPLITS):
        part = tensor_cls(idx[lo:hi], vals[lo:hi], SHAPE)
        wkw = {} if w is None else {"weights": w[lo:hi]}
        if i == 0:
            results.append(s.start(part, n_iters=4, tol=-1.0, seed=5, **wkw))
        else:
            results.append(s.update(part, **wkw))
    return s, results


def _close(got, ref):
    np.testing.assert_allclose(got.fits, ref.fits, rtol=0, atol=FIT_ATOL)
    for Fg, Fr in zip(got.factors, ref.factors):
        np.testing.assert_allclose(Fg, Fr, **FACTOR_TOL)


# -- host stages, bitwise -------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_canonical_matches_reference(seed, weighted):
    idx, vals = _rand_coo(60, seed, SMALL)
    w = (np.random.default_rng(seed).uniform(0.1, 2.0, 60).astype(np.float32)
         if weighted else None)
    got = _canonical(idx, vals, w, SMALL)
    want = r_canonical(idx, vals, w, SMALL)
    assert len(got[0]) < 60                     # repeats were summed
    for g, r in zip(got, want):
        if r is None:
            assert g is None
        else:
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("seed", range(6))
def test_merge_sorted_matches_reference(seed):
    """Both sides carry repeated coordinates before canonicalization, and
    the delta re-observes session coordinates."""
    rng = np.random.default_rng(seed + 2)
    ia, va = _rand_coo(int(rng.integers(20, 60)), seed, SMALL)
    ib, vb = _rand_coo(int(rng.integers(1, 40)), seed + 1, SMALL)
    wa = rng.uniform(0.1, 2.0, len(va)).astype(np.float32)
    wb = rng.uniform(0.1, 2.0, len(vb)).astype(np.float32)
    a = _canonical(ia, va, wa, SMALL)
    b = _canonical(ib, vb, wb, SMALL)
    for weights in (True, False):
        args = (a + b) if weights else (a[:3] + (None,) + b[:3] + (None,))
        got = _merge_sorted(*args)
        want = r_merge_sorted(*args)
        for g, r in zip(got, want):
            if r is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("mode,growth", [("geometric", 1.5), ("geometric", 1.25),
                                         ("quantum", 1.25)])
def test_session_cap_matches_reference(mode, growth):
    pol = BucketPolicy(mode=mode, growth=growth, quantum=64, min_cap=8)
    rpol = RBucketPolicy(mode=mode, growth=growth, quantum=64, min_cap=8)
    cap = rcap = 0
    for nnz in (5, 30, 300, 200, 1000, 17, 5000):
        cap, rcap = session_cap(nnz, cap, pol), r_session_cap(nnz, rcap, rpol)
        assert cap == rcap


# -- sessions against the reference --------------------------------------------------


@pytest.mark.parametrize("backend", ["slab", "segment"])
@pytest.mark.parametrize("method", ["cp", "nncp", "masked"])
def test_streaming_matches_reference(method, backend):
    idx, vals, w = _stream_data(method)
    ref, rres = _drive(RStreamingCP, RSparseTensor, method, idx, vals, w,
                       backend="segment")
    got, res = _drive(StreamingCP, SparseTensor, method, idx, vals, w,
                      backend=backend, device="cpu")
    for g, r in zip(res, rres):
        assert g.iters == r.iters
        _close(g, r)
    assert got.bucket_cap == ref.bucket_cap and got.increments == 2
    np.testing.assert_array_equal(got.tensor.indices, ref.tensor.indices)
    np.testing.assert_array_equal(got.tensor.values, ref.tensor.values)
    if method == "masked":
        np.testing.assert_array_equal(got.entry_weights, ref.entry_weights)
    if method == "nncp":
        assert all((F >= 0).all() for F in got.result.factors)


@pytest.mark.parametrize("method", ["cp", "nncp", "masked"])
def test_increment_from_converted_reference_state(method):
    """Start and one update on the reference, carry the session across,
    then one more increment on each: the port continues the reference's
    session."""
    idx, vals, w = _stream_data(method, seed=8)
    ref = RStreamingCP(3, method=method, refine_iters=2, check_every=2)
    wk = (lambda lo, hi: {} if w is None else {"weights": w[lo:hi]})
    ref.start(RSparseTensor(idx[:70], vals[:70], SHAPE), n_iters=4, tol=-1.0,
              seed=2, **wk(0, 70))
    ref.update(RSparseTensor(idx[70:105], vals[70:105], SHAPE), **wk(70, 105))
    port = stream_state_from_reference(
        ref, StreamingCP(3, method=method, refine_iters=2, check_every=2,
                         device="cpu"))
    assert port.increments == 1 and port.seed == 2
    assert port.bucket_cap == ref.bucket_cap
    r = ref.update(RSparseTensor(idx[105:], vals[105:], SHAPE), **wk(105, 130))
    g = port.update(SparseTensor(idx[105:], vals[105:], SHAPE), **wk(105, 130))
    _close(g, r)
    np.testing.assert_array_equal(port.tensor.values, ref.tensor.values)


def test_eviction_survivors_match_reference_and_by_hand():
    policy = dict(mode="geometric", growth=1.5, min_cap=8)
    decay, floor = 0.5, 0.6
    t = random_sparse(SHAPE, 60, seed=21)
    sessions = []
    for cls, pol, tcls, kw in ((StreamingCP, BucketPolicy, SparseTensor,
                                {"device": "cpu"}),
                               (RStreamingCP, RBucketPolicy, RSparseTensor, {})):
        s = cls(2, method="masked", refine_iters=2, check_every=2,
                policy=pol(**policy), decay=decay, weight_floor=floor, **kw)
        s.start(tcls(t.indices[:30], t.values[:30], SHAPE), n_iters=3,
                tol=-1.0, seed=4)
        for lo, hi in ((30, 45), (45, 60)):
            s.update(tcls(t.indices[lo:hi], t.values[lo:hi], SHAPE))
        sessions.append(s)
    got, ref = sessions
    assert got.evictions == ref.evictions > 0
    np.testing.assert_array_equal(got.tensor.indices, ref.tensor.indices)
    np.testing.assert_array_equal(got.tensor.values, ref.tensor.values)
    np.testing.assert_array_equal(got.session_weights, ref.session_weights)
    # by hand, with the port's own merge
    pol = BucketPolicy(**policy)
    k, i, v, w = _canonical(t.indices[:30], t.values[:30],
                            np.ones(30, np.float32), SHAPE)
    cap = session_cap(len(k), 0, pol)
    for lo, hi in ((30, 45), (45, 60)):
        d = _canonical(t.indices[lo:hi], t.values[lo:hi],
                       np.ones(hi - lo, np.float32), SHAPE)
        k, i, v, w = _merge_sorted(k, i, v, w * np.float32(decay), *d)
        if session_cap(len(k), cap, pol) > cap:
            keep = w >= np.float32(floor)
            k, i, v, w = k[keep], i[keep], v[keep], w[keep]
        cap = session_cap(len(k), cap, pol)
    np.testing.assert_array_equal(got.tensor.indices, i)
    np.testing.assert_array_equal(got.tensor.values, v)
    np.testing.assert_array_equal(got.session_weights, w)


# -- the port's own invariants ---------------------------------------------------------


@pytest.mark.parametrize("method", ["cp", "nncp", "masked"])
def test_quantized_equals_unquantized_on_segment_bitwise(method):
    idx, vals, w = _stream_data(method, seed=4)
    q, _ = _drive(StreamingCP, SparseTensor, method, idx, vals, w,
                  backend="segment", device="cpu")
    u, _ = _drive(StreamingCP, SparseTensor, method, idx, vals, w,
                  backend="segment", device="cpu", policy=None)
    assert q.bucket_cap > q.tensor.nnz and u.bucket_cap == 0
    for Fq, Fu in zip(q.result.factors, u.result.factors):
        np.testing.assert_array_equal(Fq, Fu)
    np.testing.assert_array_equal(q.result.weights, u.result.weights)


@pytest.mark.parametrize("method", ["cp", "masked"])
def test_quantized_within_1e5_of_unquantized_on_slab(method):
    """Padding sits at the origin: on the slab kernel it lands in row block
    0 of every mode and moves that block's summation order."""
    idx, vals, w = _stream_data(method, seed=6)
    q, _ = _drive(StreamingCP, SparseTensor, method, idx, vals, w,
                  device="cpu")
    u, _ = _drive(StreamingCP, SparseTensor, method, idx, vals, w,
                  device="cpu", policy=None)
    for Fq, Fu in zip(q.result.factors, u.result.factors):
        np.testing.assert_allclose(Fq, Fu, rtol=0, atol=1e-5)
    np.testing.assert_allclose(q.result.fits, u.result.fits, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["cp", "masked"])
def test_restore_matches_uninterrupted(tmp_path, method):
    idx, vals, w = _stream_data(method, seed=31)
    s1, _ = _drive(StreamingCP, SparseTensor, method, idx, vals, w,
                   device="cpu", decay=0.9)
    s1.save(tmp_path / "sess")
    s2 = StreamingCP.restore(tmp_path / "sess", device="cpu")
    assert (s2.increments, s2.seed, s2.bucket_cap, s2.method, s2.backend) == \
        (s1.increments, s1.seed, s1.bucket_cap, s1.method, s1.backend)
    np.testing.assert_array_equal(s2.session_weights, s1.session_weights)
    delta = random_sparse(SHAPE, 20, seed=99)
    wkw = {} if w is None else {"weights": np.full(20, 0.5, np.float32)}
    r1, r2 = s1.update(delta, **wkw), s2.update(delta, **wkw)
    assert abs(r1.fits[-1] - r2.fits[-1]) < 1e-6
    for F1, F2 in zip(r1.factors, r2.factors):
        np.testing.assert_allclose(F1, F2, rtol=0, atol=1e-6)


def test_restore_rejects_foreign_checkpoint(tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    CheckpointManager(str(tmp_path / "x"), async_save=False).save(
        0, {"a": np.zeros(3)}, extra={"kind": "other"}, block=True)
    with pytest.raises(ValueError, match="not a streaming session"):
        StreamingCP.restore(tmp_path / "x", device="cpu")
    with pytest.raises(RuntimeError, match="start"):
        StreamingCP(2, device="cpu").save(tmp_path / "y")


def test_increment_inside_bucket_adds_no_cache_miss():
    t = random_sparse(SHAPE, 120, seed=12)
    s = StreamingCP(3, refine_iters=2, check_every=2, device="cpu")
    s.start(SparseTensor(t.indices[:100], t.values[:100], SHAPE), n_iters=4,
            tol=-1.0)
    cap = s.bucket_cap
    s.update(SparseTensor(t.indices[100:110], t.values[100:110], SHAPE))
    before = sweep_cache_stats()
    with trace.capture() as tr:
        s.update(SparseTensor(t.indices[110:], t.values[110:], SHAPE))
    trace.disable()
    after = sweep_cache_stats()
    assert s.bucket_cap == cap
    assert after["misses"] == before["misses"] and after["hits"] > before["hits"]
    (ev,) = [r for r in tr.records() if r["name"] == "stream.increment"]
    assert ev["args"]["bucket_cap"] == cap and ev["args"]["counted"] is True
    assert ev["args"]["nnz"] == s.tensor.nnz


def test_runner_routes_sessions_and_resumes(tmp_path):
    runner = ALSRunner(3, check_every=2, device="cpu")
    path = tmp_path / "stream"
    s = runner.open_stream(refine_iters=2, resume_from=str(path),
                           session_id="probe")
    assert s.increments == 0 and s.runner is runner and s.backend == "slab"
    t = random_sparse(SHAPE, 90, seed=51)
    s.start(SparseTensor(t.indices[:50], t.values[:50], SHAPE), n_iters=4,
            tol=-1.0, seed=7)
    res = s.update(SparseTensor(t.indices[50:70], t.values[50:70], SHAPE))
    assert res.engine == "batched"
    g = runner.service.snapshot()["streams"]["probe"]
    assert g["increments"] == 1 and g["nnz"] == s.tensor.nnz
    assert g["bucket_cap"] == s.bucket_cap
    s.save(path)
    runner2 = ALSRunner(3, check_every=2, device="cpu")
    s2 = runner2.open_stream(resume_from=str(path))
    assert s2.runner is runner2 and s2.seed == 7 and s2.increments == 1
    r2 = s2.update(SparseTensor(t.indices[70:], t.values[70:], SHAPE))
    r1 = s.update(SparseTensor(t.indices[70:], t.values[70:], SHAPE))
    np.testing.assert_allclose(r2.fits, r1.fits, rtol=0, atol=1e-6)


def test_streaming_is_a_stateful_method():
    spec = get_method("streaming")
    assert spec.stateful and spec.session_factory is StreamingCP
    assert "streaming" not in batchable_methods()
    t = random_sparse(SHAPE, 50, seed=0)
    with pytest.raises(ValueError, match="stateful"):
        cpd_als(t, 2, method="streaming", device="cpu")
    with pytest.raises(ValueError, match="sweep-based"):
        StreamingCP(2, method="streaming", device="cpu")


def test_session_validation():
    with pytest.raises(ValueError, match="decay"):
        StreamingCP(2, decay=1.5, device="cpu")
    with pytest.raises(ValueError, match="weight_floor"):
        StreamingCP(2, weight_floor=-0.1, device="cpu")
    s = StreamingCP(2, device="cpu")
    with pytest.raises(RuntimeError, match="start"):
        s.update(random_sparse(SHAPE, 10, seed=0))
    s.start(random_sparse(SHAPE, 40, seed=0), n_iters=2, tol=-1.0)
    with pytest.raises(ValueError, match="shape"):
        s.update(random_sparse((3, 3, 3), 5, seed=0))
    with pytest.raises(ValueError, match="weighted-fit"):
        s.update(random_sparse(SHAPE, 5, seed=1), weights=np.ones(5))


def test_cuda_is_the_default_device():
    import torch

    if torch.cuda.is_available():
        assert StreamingCP(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            StreamingCP(2)
