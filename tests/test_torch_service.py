"""Port vs JAX package: the decomposition service on the CPU.

The scheduler's flush sequence (bucket keys, batch sizes, triggers) under
one scripted submit/poll/flush sequence with an injected clock, the
metrics' snapshot keys, density profiles and the plan fields they move
(``seg_kappa`` / ``seg_scheme``) are held bitwise against the reference.
Results of ``DecompositionService`` (synchronous and double-buffered) and
``ALSRunner`` (batched and sequential) are held against the reference's
single-device (``mesh=None``) path at the tolerances of
``test_torch_methods.py``.  Inside the port, double-buffered results are
bitwise the synchronous ones, compared only after ``drain()``.  No test
triggers a flush by sleeping or timing.
"""
import numpy as np
import pytest

from repro.core import plan as r_plan
from repro.core import random_sparse as r_random_sparse
from repro.runtime import ALSRunner as RALSRunner
from repro.runtime import StragglerMonitor as RStragglerMonitor
from repro.serve import BatchedEngine as RBatchedEngine
from repro.serve import BatchScheduler as RBatchScheduler
from repro.serve import BucketPolicy as RBucketPolicy
from repro.serve import DecompositionService as RDecompositionService
from repro.serve import ServiceMetrics as RServiceMetrics
from repro_torch.core import plan as plan_mod
from repro_torch.core.coo import random_sparse
from repro_torch.core.cpd import CPDResult
from repro_torch.runtime import ALSRunner, StragglerMonitor
from repro_torch.serve import (BatchedEngine, BatchScheduler, BucketPolicy,
                               DecompositionService, ServiceMetrics)

FIT_ATOL = 1e-4
FACTOR_TOL = dict(rtol=1e-3, atol=1e-5)
SHAPE_A = (12, 9, 7)
SHAPE_B = (16, 6, 5)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _close(got, ref):
    assert got.iters == ref.iters
    np.testing.assert_allclose(got.fits, ref.fits, rtol=0, atol=FIT_ATOL)
    for Fg, Fr in zip(got.factors, ref.factors):
        np.testing.assert_allclose(Fg, Fr, **FACTOR_TOL)


def _bitwise(a, b):
    assert a.iters == b.iters and a.fits == b.fits
    assert a.host_syncs == b.host_syncs
    for Fa, Fb in zip(a.factors, b.factors):
        assert np.array_equal(Fa, Fb)
    assert np.array_equal(a.weights, b.weights)


def _requests(make, n, nnz=100, shape=SHAPE_A):
    return [make(shape, nnz - 7 * i, seed=100 + i, distribution="powerlaw")
            for i in range(n)]


# -- the scheduler's flush sequence, bitwise -----------------------------------------

# (op, argument): submit a request of bucket A or B, advance the clock,
# poll, or force a flush.  Every trigger fires: max_batch (3rd A), aging
# (A waited most of its budget when B fills), max_wait, forced.
SCRIPT = [("A", 0), ("A", 1), ("A", 2), ("B", 0), ("tick", 0.4), ("B", 1),
          ("A", 3), ("tick", 0.7), ("poll", None), ("B", 2), ("tick", 1.1),
          ("A", 4), ("poll", None), ("B", 3), ("A", 5), ("flush", None)]


def _play(sched, clock, make):
    reqs = {"A": _requests(make, 6, shape=SHAPE_A),
            "B": _requests(make, 4, nnz=80, shape=SHAPE_B)}
    flushed, futs = [], []
    for op, arg in SCRIPT:
        if op in reqs:
            futs.append(sched.submit(reqs[op][arg], n_iters=2, tol=-1.0,
                                     seed=arg))
            flushed.append(None)
        elif op == "tick":
            clock.advance(arg)
        elif op == "poll":
            flushed.append(sched.poll())
        else:
            flushed.append(sched.flush())
    sched.join()
    events = [(e.bucket_key, e.batch_size, e.trigger)
              for e in sched.metrics.batches]
    return flushed, events, [f.result() for f in futs]


@pytest.mark.parametrize("double_buffer", [False, True])
def test_flush_sequence_matches_reference(double_buffer):
    kw = dict(max_batch=3, max_wait_s=1.0)
    clock, rclock = FakeClock(), FakeClock()
    ours = BatchScheduler(BatchedEngine(3, kappa=2, check_every=2, device="cpu"),
                          policy=BucketPolicy(), metrics=ServiceMetrics(),
                          clock=clock, double_buffer=double_buffer, **kw)
    ref = RBatchScheduler(RBatchedEngine(rank=3, kappa=2, backend="segment",
                                         check_every=2),
                          policy=RBucketPolicy(), metrics=RServiceMetrics(),
                          clock=rclock, **kw)
    got = _play(ours, clock, random_sparse)
    want = _play(ref, rclock, r_random_sparse)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert {t for _, _, t in got[1]} == {"max_batch", "aging", "max_wait",
                                         "forced"}
    for g, r in zip(got[2], want[2]):
        _close(g, r)
    snap, rsnap = ours.metrics.snapshot(), ref.metrics.snapshot()
    for key in ("submitted", "completed", "batches", "flush_triggers",
                "padding_overhead", "batch_occupancy", "queue"):
        assert snap[key] == rsnap[key], key


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) and k not in (
        "bucket_latency_p99_s", "streams", "device_dispatches") else None
        for k, v in d.items()}


def test_snapshot_keys_match_reference():
    snaps = []
    for metrics in (ServiceMetrics(), RServiceMetrics()):
        metrics.record_stream_increment("s", bucket_cap=8, nnz=5, evicted=0,
                                        wall_s=0.1, merge_s=0.01)
        snaps.append(metrics.snapshot())
    assert _keys(snaps[0]) == _keys(snaps[1])
    assert set(snaps[0]["streams"]["s"]) == set(snaps[1]["streams"]["s"])


@pytest.mark.parametrize("seed", range(3))
def test_density_feedback_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ours, ref = ServiceMetrics(), RServiceMetrics()
    key = ((40, 9, 7), 512, "cp")
    for i in range(3):
        t = random_sparse((40, 9, 7), 300, seed=seed * 10 + i,
                          distribution="powerlaw")
        profiles = tuple(plan_mod.density_profile(t.indices, t.shape, d)
                         for d in range(3))
        assert profiles == tuple(r_plan.density_profile(t.indices, t.shape, d)
                                 for d in range(3))
        if rng.uniform() < 0.5:
            profiles = (profiles[0], None, profiles[2])
        ours.record_density(key, profiles)
        ref.record_density(key, profiles)
        assert ours.row_density(key) == ref.row_density(key)


# -- plans under an observed density -----------------------------------------------

PROFILES = [
    None,
    (0.125,) * 8,
    (0.6, 0.2, 0.1, 0.05, 0.05, 0.0, 0.0, 0.0),
    (1.0, 0, 0, 0, 0, 0, 0, 0),
    (0.0,) * 8,
]


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("kappa", [1, 4, 16])
def test_plan_bucket_density_matches_reference(profile, kappa):
    shape, cap = (300, 24, 7), 4096
    density = (profile, None, profile)
    got = plan_mod.plan_bucket(shape, cap, 8, kappa, density=density)
    want = r_plan.plan_bucket(shape, cap, 8, kappa, density=density)
    assert ([(m.seg_kappa, m.seg_scheme) for m in got.modes]
            == [(m.seg_kappa, m.seg_scheme) for m in want.modes])
    for d in (0, 2):
        if profile is None:
            continue
        s = plan_mod._ObservedModeStats(shape, d, cap, profile)
        rs = r_plan._ObservedModeStats(shape, d, cap, profile)
        np.testing.assert_array_equal(s.row_ptr, rs.row_ptr)
        assert (plan_mod.choose_segment_partition(s, kappa)
                == r_plan.choose_segment_partition(rs, kappa))
    uni = plan_mod._UniformModeStats(shape, 1, cap)
    np.testing.assert_array_equal(uni.row_ptr,
                                  r_plan._UniformModeStats(shape, 1, cap).row_ptr)
    # the port's tiling does not move with the profile
    plain = plan_mod.plan_bucket(shape, cap, 8, kappa)
    assert got.slab_meta() == plain.slab_meta()


def test_plan_bucket_rejects_a_short_density():
    with pytest.raises(ValueError, match="one profile per mode"):
        plan_mod.plan_bucket((30, 7, 5), 512, 4, density=((0.125,) * 8,))
    with pytest.raises(ValueError, match="bins"):
        plan_mod.plan_bucket((30, 7, 5), 512, 4, density=((1.0,), None, None))


# -- results against the reference -------------------------------------------------


def _weights(ts):
    return [np.random.default_rng(30 + i).uniform(0.2, 1.0, t.nnz)
            .astype(np.float32) for i, t in enumerate(ts)]


def _serve(svc, ts, method, ws):
    futs = [svc.submit(t, n_iters=4, tol=-1.0, seed=i, method=method,
                       **({"weights": ws[i]} if ws else {}))
            for i, t in enumerate(ts)]
    svc.drain()
    return [f.result() for f in futs]


@pytest.mark.parametrize("method", ["cp", "nncp", "masked"])
def test_service_matches_reference_and_double_buffer_is_bitwise(method):
    ts = _requests(random_sparse, 5) + _requests(random_sparse, 2, nnz=80,
                                                 shape=SHAPE_B)
    rts = _requests(r_random_sparse, 5) + _requests(r_random_sparse, 2,
                                                    nnz=80, shape=SHAPE_B)
    ws = _weights(ts) if method == "masked" else None
    kw = dict(kappa=2, check_every=2, max_batch=3, max_wait_s=1e9)
    ref = _serve(RDecompositionService(3, backend="segment", **kw), rts,
                 method, ws)
    sync_svc = DecompositionService(3, device="cpu", **kw)
    db_svc = DecompositionService(3, device="cpu", double_buffer=True, **kw)
    sync = _serve(sync_svc, ts, method, ws)
    db = _serve(db_svc, ts, method, ws)
    for s, d, r in zip(sync, db, ref):
        _close(s, r)
        _bitwise(s, d)
        assert s.host_syncs == 3           # 4 sweeps at check_every=2
    for svc in (sync_svc, db_svc):
        snap = svc.snapshot()
        assert snap["batches"] == snap["dispatch"]["count"] == 3
        assert snap["completed"] == len(ts)
    assert sync_svc.snapshot()["dispatch"]["overlap_s"] == 0.0


@pytest.mark.parametrize("mode", ["batched", "sequential"])
def test_runner_matches_reference(mode):
    shape = (13, 8, 6)                 # a class no other test of this file runs
    ts = _requests(random_sparse, 3, shape=shape)
    rts = _requests(r_random_sparse, 3, shape=shape)
    ours = ALSRunner(3, kappa=2, check_every=2, mode=mode, device="cpu")
    ref = RALSRunner(3, kappa=2, backend="segment", check_every=2, mode=mode)
    for i, (t, rt) in enumerate(zip(ts, rts)):
        g = ours.decompose(t, n_iters=4, tol=-1.0, seed=i, log=lambda s: None)
        r = ref.decompose(rt, n_iters=4, tol=-1.0, seed=i, log=lambda s: None)
        _close(g, r)
        assert g.engine == ("batched" if mode == "batched" else "fused")
    assert [set(h) for h in ours.history] == [set(h) for h in ref.history]
    assert [h["request"] for h in ours.history] == [1, 2, 3]
    # the first request of a class misses the window cache, later ones hit
    assert ours.history[0]["sweep_cache_misses"] >= 1
    assert ours.history[2]["sweep_cache_misses"] == 0
    assert ours.history[2]["sweep_cache_hits"] >= 1


def test_runner_async_and_flush():
    runner = ALSRunner(3, kappa=2, check_every=2, max_batch=8, device="cpu")
    futs = [runner.decompose_async(t, n_iters=2, tol=-1.0)
            for t in _requests(random_sparse, 3)]
    assert not any(f.done() for f in futs) and runner.poll() == 0
    assert runner.flush() == 1 and all(f.done() for f in futs)
    seq = ALSRunner(3, mode="sequential", device="cpu")
    with pytest.raises(RuntimeError, match="batched"):
        seq.decompose_async(_requests(random_sparse, 1)[0])
    assert ALSRunner(3, engine="host", device="cpu").mode == "sequential"
    with pytest.raises(ValueError):
        ALSRunner(3, engine="host", mode="batched", device="cpu")


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(4)
    dts = list(rng.uniform(0.9, 1.1, 12)) + [5.0] + list(rng.uniform(0.9, 1.1, 5))
    ours, ref = StragglerMonitor(), RStragglerMonitor()
    flags = [(ours.observe(i, dt), ref.observe(i, dt)) for i, dt in enumerate(dts)]
    assert all(a == b for a, b in flags) and any(a for a, _ in flags)
    assert ours.events == ref.events


# -- the port's scheduler invariants ------------------------------------------------


def test_batch_quantum_changes_no_result():
    ts = _requests(random_sparse, 3)
    out = []
    for q in (1, 2):
        svc = DecompositionService(3, kappa=2, check_every=2, max_batch=4,
                                   batch_quantum=q, device="cpu")
        out.append(_serve(svc, ts, "cp", None))
    for a, b in zip(*out):
        _bitwise(a, b)


def _fake_result(t):
    return CPDResult(factors=[np.zeros((s, 3)) for s in t.shape],
                     weights=np.ones(3), fits=[0.0], iters=1,
                     mttkrp_seconds=0.0, total_seconds=0.0)


class _SpyEngine:
    rank = 3
    mesh = None
    num_devices = 1

    def __init__(self, order):
        import torch

        self.device = torch.device("cpu")
        self.order = order
        self.densities = []

    def prepare_batch(self, ts, **kw):
        self.order.append(tuple(ts[0].shape))
        self.densities.append(kw["density"])
        return [_fake_result(t) for t in ts]

    def execute_prepared(self, prep):
        return prep


def test_neediest_bucket_flushes_first_and_density_feeds_back():
    order = []
    clock = FakeClock()
    spy = _SpyEngine(order)
    sched = BatchScheduler(spy, policy=BucketPolicy(), max_batch=8,
                           max_wait_s=1.0, metrics=ServiceMetrics(), clock=clock)
    sched.submit(_requests(random_sparse, 1)[0], n_iters=1)
    clock.advance(0.5)
    sched.submit(_requests(random_sparse, 1, nnz=80, shape=SHAPE_B)[0],
                 n_iters=1)
    clock.advance(2.0)                     # both expired; A waited longer
    assert sched.poll() == 2
    assert order == [SHAPE_A, SHAPE_B]
    assert spy.densities == [None, None]
    sched.submit(_requests(random_sparse, 1)[0], n_iters=1)
    assert sched.flush() == 1
    assert spy.densities[-1] == sched.metrics.row_density(
        BucketPolicy().bucket_for(_requests(random_sparse, 1)[0]).key)
    assert spy.densities[-1] is not None


def test_cross_bucket_aging_prevents_starvation():
    clock = FakeClock()
    sched = BatchScheduler(_SpyEngine([]), policy=BucketPolicy(), max_batch=2,
                           max_wait_s=10.0, metrics=ServiceMetrics(), clock=clock)
    lone = sched.submit(_requests(random_sparse, 1, nnz=80, shape=SHAPE_B)[0])
    rounds = 0
    while not lone.done():
        assert rounds < 20, "lone request starved by busy bucket"
        for t in _requests(random_sparse, 2):
            sched.submit(t)
        clock.advance(1.0)
        rounds += 1
    assert rounds <= 11
    assert sched.metrics.snapshot()["flush_triggers"]["aging"] >= 1


class _Interrupt(BaseException):
    """Not an ``Exception``: what a Ctrl-C looks like to the scheduler."""


def _failing_flush(sched, half, error):
    """Two requests of one bucket and one of another, an engine whose
    ``half`` raises ``error``, then a forced flush and ``join()``: the
    futures and whatever escaped to the caller."""
    make = (random_sparse if isinstance(sched, BatchScheduler)
            else r_random_sparse)
    futs = [sched.submit(t, n_iters=2, tol=-1.0)
            for t in _requests(make, 2) + _requests(make, 1, nnz=80, shape=SHAPE_B)]

    def boom(*a, **k):
        raise error("engine down")

    setattr(sched.engine, half, boom)
    try:
        sched.flush()
        sched.join()
    except BaseException as exc:
        return futs, exc
    return futs, None


@pytest.mark.parametrize("error", [RuntimeError, _Interrupt],
                         ids=["exception", "base_exception"])
@pytest.mark.parametrize("half", ["prepare_batch", "execute_prepared"])
@pytest.mark.parametrize("double_buffer", [False, True])
def test_engine_error_delivered_via_futures(half, double_buffer, error):
    """Every future of every popped batch is resolved with the engine's
    error, whatever its class, as in the reference; the port then hands
    an error that is not an ``Exception`` on to the caller (from the
    flush, or from ``join()`` when the failing half ran on the dispatch
    worker), where the reference drops it."""
    kw = dict(max_batch=8, max_wait_s=1e9, clock=FakeClock(),
              double_buffer=double_buffer)
    port = BatchScheduler(BatchedEngine(3, kappa=2, check_every=2, device="cpu"),
                          metrics=ServiceMetrics(), **kw)
    ref = RBatchScheduler(RBatchedEngine(3, kappa=2, check_every=2),
                          metrics=RServiceMetrics(), **kw)
    futs, escaped = _failing_flush(port, half, error)
    rfuts, rescaped = _failing_flush(ref, half, error)
    assert rescaped is None
    if issubclass(error, Exception):
        assert escaped is None
    else:
        assert isinstance(escaped, error)
    assert [f.done() for f in futs] == [f.done() for f in rfuts] == [True] * 3
    assert port.pending() == ref.pending() == 0
    for f, rf in zip(futs, rfuts):
        for fut in (f, rf):
            with pytest.raises(error, match="engine down"):
                fut.result()


def test_submit_validates_weights_eagerly():
    sched = BatchScheduler(_SpyEngine([]), max_batch=8, max_wait_s=1e9,
                           clock=FakeClock())
    t = _requests(random_sparse, 1)[0]
    with pytest.raises(ValueError, match="weighted-fit"):
        sched.submit(t, weights=np.ones(t.nnz))
    with pytest.raises(ValueError, match="align"):
        sched.submit(t, method="masked", weights=np.ones(t.nnz + 1))
    with pytest.raises(ValueError, match="nonnegative"):
        sched.submit(t, method="masked", weights=-np.ones(t.nnz))
    assert sched.pending() == 0


def test_result_forces_flush_and_timeout_does_not():
    sched = BatchScheduler(BatchedEngine(3, kappa=2, check_every=2, device="cpu"),
                           max_batch=8, max_wait_s=1e9, clock=FakeClock())
    fut = sched.submit(_requests(random_sparse, 1)[0], n_iters=2, tol=-1.0)
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.0)
    assert sched.pending() == 1
    assert fut.result().iters == 2 and sched.pending() == 0


def test_service_defaults_to_the_card_and_the_kernel():
    import torch

    if torch.cuda.is_available():
        svc = DecompositionService(4)
        assert svc.engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            DecompositionService(4)
        svc = DecompositionService(4, device="cpu")
    assert svc.engine.backend == "slab"
    assert svc.engine.num_devices == 1 and svc.engine.mesh is None


def test_metrics_writers_and_readers_keep_exact_totals():
    """Scheduler threads write while dashboards read: totals stay exact and
    no snapshot is torn (``completed`` tracks ``batches`` 2:1)."""
    import sys
    import threading

    from repro_torch.serve.metrics import BatchEvent

    writers, per_writer = 4, 100
    m = ServiceMetrics(window=writers * per_writer * 2 + 10)
    stop, torn = threading.Event(), []

    def write():
        for i in range(per_writer):
            m.record_submit(now=float(i))
            m.record_submit(now=float(i))
            m.record_batch(BatchEvent(("b", i % 3), 2, 4, 10, 16, 0.001,
                                      "max_batch", 1, 1), [0.001, 0.002],
                           now=float(i) + 0.5)
            m.record_density(("b", i % 3), ((0.5, 0.5), None))
            m.record_dispatch(devices=[0], assembly_s=0.1, execute_s=0.2,
                              overlap_s=0.05)

    def read():
        while not stop.is_set():
            snap = m.snapshot()
            if snap["completed"] != 2 * snap["batches"]:
                torn.append(snap)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = [threading.Thread(target=read) for _ in range(2)]
        threads = [threading.Thread(target=write) for _ in range(writers)]
        for t in readers + threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        for t in readers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in readers + threads)
    assert not torn
    snap = m.snapshot()
    n = writers * per_writer
    assert (snap["submitted"], snap["completed"], snap["batches"]) == (2 * n, 2 * n, n)
    assert snap["dispatch"]["count"] == n and snap["cache_hits"] == n
    assert snap["density_tracked_buckets"] == 3
