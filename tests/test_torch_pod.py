"""Port vs JAX package: the pod path of the batched engine on the CPU.

``BatchedEngine(mesh=...)`` runs on a batch mesh of κ = 2 gloo ranks
(one spawned group for the module) and on a mesh of one rank in this
process.  Every rank decomposes the same requests, runs its own block of
lanes and gathers every lane's results.  The reference's pod path is
broken under the installed jax (``ROADMAP.md`` C-ref1), so the oracle is
its ``BatchedEngine(mesh=None)`` on the same requests and seeds, at the
reference's own pod tolerances (``tests/serve/test_pod_engine.py``): fits
within 1e-5, factors within 1e-4.  The pod's contract is held too: one
host read per batch, ``engine == "pod"``, padding lanes invisible, and the
``pod.window`` event counting the reference's windows.  The reference is
imported inside the fixture that uses it, so that the spawned ranks,
which import this module, do not load JAX.
"""
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.core.coo import random_sparse
from repro_torch.launch import BATCH_AXIS, make_batch_mesh, spawn_ranks
from repro_torch.obs import trace
from repro_torch.serve import BatchedEngine, DecompositionService

SHAPE = (18, 13, 9)
R, CHECK_EVERY, CAP = 3, 4, 512
ITERS = [10, 6, 10, 12, 12]
METHODS = ["cp", "nncp", "masked"]
SPAWN_TIMEOUT = 240.0


def _stream(make, n=5, nnz=480):
    return [make(SHAPE, nnz - 17 * i, seed=i, distribution="powerlaw")
            for i in range(n)]


def _weights(ts):
    return [np.random.default_rng(20 + i).uniform(0.2, 1.0, t.nnz)
            .astype(np.float32) for i, t in enumerate(ts)]


def _result(r):
    return dict(fits=r.fits, factors=r.factors, weights=r.weights,
                iters=r.iters, host_syncs=r.host_syncs, engine=r.engine,
                method=r.method)


def rank_pod(mesh):
    """Every pod case on this rank; returns plain data."""
    ts = _stream(random_sparse)
    out = {"rank": mesh.rank, "methods": {}, "windows": {}}
    for method in METHODS:
        kw = dict(weights=_weights(ts)) if method == "masked" else {}
        eng = BatchedEngine(R, kappa=2, backend="slab", check_every=CHECK_EVERY,
                            mesh=mesh)
        with trace.capture() as tr:
            res = eng.decompose_batch(ts, n_iters=ITERS, tol=-1.0,
                                      seeds=list(range(5)), nnz_cap=CAP,
                                      method=method, **kw)
        out["methods"][method] = [_result(r) for r in res]
        out["windows"][method] = [r for r in tr.records()
                                  if r["name"] in ("pod.window", "pod.dispatch")]
    # B = 3 on a quantum of 2: 4 lanes dispatched (a mesh multiple too).
    three = _stream(random_sparse, n=3)
    eng = BatchedEngine(R, kappa=2, backend="slab", check_every=2, mesh=mesh,
                        batch_quantum=2)
    prep = eng.prepare_batch(three, n_iters=4, tol=-1.0, seeds=[7, 8, 9],
                             nnz_cap=CAP)
    out["padded"] = dict(batch=prep.batch, local=int(prep.carry[1].shape[0]),
                         results=[_result(r) for r in eng.execute_prepared(prep)])
    # Placement: balanced and contiguous give the same per-request results.
    skewed = [random_sparse(SHAPE, n, seed=10 + i, distribution="powerlaw")
              for i, n in enumerate([500, 480, 140, 120])]
    # A zero iteration budget returns the initial states (ROADMAP C3).
    eng = BatchedEngine(R, kappa=2, backend="slab", check_every=CHECK_EVERY,
                        mesh=mesh)
    with trace.capture() as tr:
        out["zero"] = [_result(r) for r in eng.decompose_batch(
            three, n_iters=0, seeds=[7, 8, 9], nnz_cap=CAP)]
    out["zero_events"] = [r["name"] for r in tr.records()]
    out["placement"] = {}
    for placement in ("balanced", "contiguous"):
        eng = BatchedEngine(R, backend="segment", check_every=2, mesh=mesh,
                            lane_placement=placement)
        prep = eng.prepare_batch(skewed, n_iters=4, tol=-1.0,
                                 seeds=[1, 2, 3, 4], nnz_cap=CAP)
        out["placement"][placement] = dict(
            lane_of=prep.lane_of,
            results=[_result(r) for r in eng.execute_prepared(prep)])
    return out


@pytest.fixture(scope="module")
def reference():
    from repro.core import random_sparse as r_random_sparse
    from repro.serve import BatchedEngine as RBatchedEngine

    ts = _stream(r_random_sparse)
    out = {}
    for method in METHODS:
        kw = dict(weights=_weights(ts)) if method == "masked" else {}
        out[method] = RBatchedEngine(rank=R, kappa=2, backend="segment",
                                     check_every=CHECK_EVERY).decompose_batch(
            ts, n_iters=ITERS, tol=-1.0, seeds=list(range(5)), nnz_cap=CAP,
            method=method, **kw)
    out["padded"] = RBatchedEngine(rank=R, kappa=2, backend="segment",
                                   check_every=2).decompose_batch(
        _stream(r_random_sparse, n=3), n_iters=4, tol=-1.0, seeds=[7, 8, 9],
        nnz_cap=CAP)
    out["zero"] = RBatchedEngine(rank=R, kappa=2, backend="segment",
                                 check_every=CHECK_EVERY).decompose_batch(
        _stream(r_random_sparse, n=3), n_iters=0, seeds=[7, 8, 9], nnz_cap=CAP)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{kappa: [per-rank results]}: κ = 2 spawned over gloo, κ = 1 here."""
    one = rank_pod(make_batch_mesh(1, device="cpu"))
    two = spawn_ranks(rank_pod, 2, timeout=SPAWN_TIMEOUT, device="cpu",
                      workdir=tmp_path_factory.mktemp("pod_ranks"))
    return {1: [one], 2: two}


def _close(got, ref):
    assert got["iters"] == ref.iters
    np.testing.assert_allclose(got["fits"], ref.fits, rtol=1e-5, atol=1e-5)
    for Fa, Fb in zip(got["factors"], ref.factors):
        np.testing.assert_allclose(Fa, Fb, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kappa", [1, 2])
@pytest.mark.parametrize("method", METHODS)
def test_pod_matches_reference_batched(ranks, reference, kappa, method):
    for r in ranks[kappa]:
        got = r["methods"][method]
        assert len(got) == 5
        for g, ref in zip(got, reference[method]):
            assert g["engine"] == "pod" and g["method"] == method
            assert g["host_syncs"] == 1
            _close(g, ref)


@pytest.mark.parametrize("method", METHODS)
def test_pod_results_bitwise_across_ranks(ranks, method):
    a, b = (r["methods"][method] for r in ranks[2])
    for x, y in zip(a, b):
        assert x["fits"] == y["fits"]
        for Fa, Fb in zip(x["factors"], y["factors"]):
            assert np.array_equal(Fa, Fb)


@pytest.mark.parametrize("method", METHODS)
def test_pod_equals_one_rank_bitwise(ranks, method):
    for x, y in zip(ranks[2][0]["methods"][method], ranks[1][0]["methods"][method]):
        assert x["fits"] == y["fits"]
        for Fa, Fb in zip(x["factors"], y["factors"]):
            assert np.array_equal(Fa, Fb)


@pytest.mark.parametrize("kappa", [1, 2])
@pytest.mark.parametrize("method", METHODS)
def test_pod_window_event_counts_reference_windows(ranks, kappa, method):
    for r in ranks[kappa]:
        recs = r["windows"][method]
        window = [x for x in recs if x["name"] == "pod.window"]
        dispatch = [x for x in recs if x["name"] == "pod.dispatch"]
        assert len(window) == len(dispatch) == 1
        args = window[0]["args"]
        # tol = -1: no lane converges early, every window runs
        assert args["windows"] == math.ceil(max(ITERS) / CHECK_EVERY)
        assert args["devices"] == kappa and args["rescued"] is False
        assert args["windows_after_convergence"] == 0
        d = dispatch[0]["args"]
        assert d["B"] == (6 if kappa == 2 else 5) and d["devices"] == kappa
        assert sum(d["device_nnz"]) >= sum(480 - 17 * i for i in range(5))


@pytest.mark.parametrize("kappa", [1, 2])
def test_pod_padding_is_invisible(ranks, reference, kappa):
    for r in ranks[kappa]:
        pad = r["padded"]
        assert pad["batch"] == 4 and pad["local"] == 4 // kappa
        assert len(pad["results"]) == 3
        for g, ref in zip(pad["results"], reference["padded"]):
            assert g["host_syncs"] == 1
            _close(g, ref)


@pytest.mark.parametrize("kappa", [1, 2])
def test_lane_placement_gives_the_same_results(ranks, kappa):
    for r in ranks[kappa]:
        bal, con = r["placement"]["balanced"], r["placement"]["contiguous"]
        assert con["lane_of"] is None
        if kappa == 2:
            assert bal["lane_of"] is not None      # the skewed stream is dealt
        for a, b in zip(bal["results"], con["results"]):
            assert a["fits"] == b["fits"]
            for Fa, Fb in zip(a["factors"], b["factors"]):
                assert np.array_equal(Fa, Fb)


def test_service_on_a_mesh_of_one_rank():
    ts = _stream(random_sparse, n=4)
    mesh = make_batch_mesh(1, device="cpu")
    svc = DecompositionService(R, backend="slab", max_batch=4, check_every=2,
                               mesh=mesh, device="cpu")
    futs = [svc.submit(t, n_iters=4, tol=-1.0, seed=i) for i, t in enumerate(ts)]
    svc.drain()
    got = [f.result() for f in futs]
    assert all(g.engine == "pod" and g.host_syncs == 1 for g in got)
    snap = svc.snapshot()
    assert snap["dispatch"]["device_dispatches"] == {0: snap["batches"]}
    eng = BatchedEngine(R, backend="slab", check_every=2, device="cpu")
    cap = svc.scheduler.policy.nnz_cap(max(t.nnz for t in ts))
    ref = eng.decompose_batch(ts, n_iters=4, tol=-1.0, seeds=list(range(4)),
                              nnz_cap=cap)
    for g, r in zip(got, ref):
        assert g.fits == r.fits


@pytest.mark.parametrize("kappa", [1, 2])
def test_pod_zero_budget_returns_the_initial_state(ranks, reference, kappa):
    """``n_iters=0`` on the pod path: no sweep, one host read, the initial
    states, as the reference's early return gives (and its
    ``BatchedEngine(mesh=None)``, the oracle here)."""
    for r in ranks[kappa]:
        assert "pod.dispatch" not in r["zero_events"]
        assert len(r["zero"]) == 3
        for g, ref in zip(r["zero"], reference["zero"]):
            assert g["iters"] == ref.iters == 0 and g["fits"] == ref.fits == []
            assert g["host_syncs"] == 1 and g["engine"] == "pod"
            for Fa, Fb in zip(g["factors"], ref.factors):
                np.testing.assert_allclose(Fa, Fb, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(g["weights"], ref.weights, rtol=1e-6)


def test_service_refuses_a_mesh_of_several_ranks():
    """Over several ranks only the controller (rank 0) takes requests: a
    follower's ``submit`` and ``poll`` raise, before any collective
    (``tests/test_torch_service_mesh.py`` runs the ranks)."""
    fake = types.SimpleNamespace(size=2, rank=1, axis_names=(BATCH_AXIS,),
                                 device=torch.device("cpu"))
    svc = DecompositionService(R, mesh=fake, device="cpu")
    assert not svc.controller
    with pytest.raises(RuntimeError, match="only the controller"):
        svc.submit(_stream(random_sparse, n=1)[0])
    with pytest.raises(RuntimeError, match="only the controller"):
        svc.poll()
    assert svc.scheduler.pending() == 0


def test_engine_refuses_a_2d_mesh_and_bad_placement():
    fake = types.SimpleNamespace(size=4, rank=0, axis_names=("a", "b"))
    with pytest.raises(ValueError, match="1-D"):
        BatchedEngine(R, mesh=fake, device="cpu")
    with pytest.raises(ValueError, match="pod_plan is undefined"):
        BatchedEngine(R, device="cpu").pod_plan(SHAPE, CAP)
