"""Port vs JAX package: the decomposition service over κ = 2 ranks, and the
optimizer's cross-pod mean, on the CPU.

One spawned group of two gloo ranks runs every case of ``rank_cases``;
the same function runs in this process on a mesh of one rank.  Rank 0 is
the service's controller: it submits the requests, scripted with a fake
clock (no sleeps), and rank 1 serves the flushes in ``drain()``.  The
κ = 2 service must give bitwise the results of the port's service on a
mesh of one, which in turn is held against the reference's
``DecompositionService(mesh=None)`` at the batched engine's tolerances
(``tests/test_torch_batched.py``); the reference's own mesh path is broken
under the installed jax (``ROADMAP.md`` C-ref1).  ``cross_pod_mean`` over
the two ranks is held against the reference's quantizer applied on the
host to both ranks' inputs.  The reference is imported inside the
functions that use it, so that the spawned ranks, which import this
module, do not load JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.core.coo import random_sparse
from repro_torch.launch import make_batch_mesh, make_mesh, spawn_ranks
from repro_torch.serve import DecompositionService

R = 3
METHODS = ["cp", "nncp", "masked"]
FIT_ATOL = 1e-4
FACTOR_TOL = dict(rtol=1e-3, atol=1e-5)
SHAPE_A, SHAPE_B = (12, 9, 7), (16, 6, 5)
SERVICE = dict(kappa=2, check_every=2, max_batch=3, max_wait_s=1e9)
GRAD_SHAPES = {"dA": (7, 4), "dB": (5, 4)}
FEEDBACK_STEPS = 3
SPAWN_TIMEOUT = 240.0


class FakeClock:
    def __call__(self):
        return 0.0


def _requests(make):
    a = [make(SHAPE_A, 100 - 7 * i, seed=100 + i, distribution="powerlaw")
         for i in range(5)]
    b = [make(SHAPE_B, 80 - 7 * i, seed=100 + i, distribution="powerlaw")
         for i in range(2)]
    return a + b


def _weights(ts):
    return [np.random.default_rng(30 + i).uniform(0.2, 1.0, t.nnz)
            .astype(np.float32) for i, t in enumerate(ts)]


def _serve(svc, ts, method):
    ws = _weights(ts) if method == "masked" else None
    futs = [svc.submit(t, n_iters=4, tol=-1.0, seed=i, method=method,
                       **({"weights": ws[i]} if ws else {}))
            for i, t in enumerate(ts)]
    svc.drain()
    return futs


def _result(r):
    return dict(fits=r.fits, factors=r.factors, weights=r.weights, iters=r.iters,
                host_syncs=r.host_syncs, engine=r.engine, method=r.method)


def _service(mesh, **kw):
    return DecompositionService(R, mesh=mesh, device="cpu", clock=FakeClock(),
                                **SERVICE, **kw)


def _grads(rank: int, step: int) -> dict:
    rng = np.random.default_rng(1000 * rank + step)
    return {k: (3.0 * rng.standard_normal(s)).astype(np.float32)
            for k, s in GRAD_SHAPES.items()}


def rank_cases(mesh):
    """Every case on this rank; returns plain data.  On a follower the
    service entries are the flush counts its ``drain()`` served."""
    ts = _requests(random_sparse)
    lead = mesh.rank == 0
    out = {"rank": mesh.rank, "service": {}}
    for method in METHODS:
        svc = _service(mesh)
        if lead:
            out["service"][method] = [_result(f.result()) for f in _serve(svc, ts, method)]
            out.setdefault("batches", {})[method] = svc.snapshot()["batches"]
        else:
            out["service"][method] = svc.drain()
    # Double buffering: every collective stays on the dispatch worker.
    svc = _service(mesh, double_buffer=True)
    out["double_buffer"] = ([_result(f.result()) for f in _serve(svc, ts, "cp")]
                            if lead else svc.drain())
    # A follower that fails to prepare: the controller's futures say so,
    # and the next flush runs.
    svc = _service(mesh)
    if lead:
        first = svc.submit(ts[0], n_iters=2, tol=-1.0)
        svc.scheduler.flush()
        second = svc.submit(ts[1], n_iters=2, tol=-1.0)
        svc.drain()
        try:
            first.result()
            out["follower_error"] = None
        except RuntimeError as exc:
            out["follower_error"] = str(exc)
        out["after_error"] = _result(second.result())
    else:
        prepare, calls = svc.engine.prepare_batch, []

        def fail_once(*a, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise ValueError("follower down")
            return prepare(*a, **kw)

        svc.engine.prepare_batch = fail_once
        out["served_after_error"] = svc.drain()
    try:
        if not lead:
            svc.submit(ts[0])
        out["follower_submit"] = None
    except RuntimeError as exc:
        out["follower_submit"] = str(exc)
    # cross_pod_mean over the 'pod' axis, then error feedback.
    pod = make_mesh((mesh.size,), ("pod",), device="cpu")
    err = {k: torch.zeros(s) for k, s in GRAD_SHAPES.items()}
    out["mean"], out["mean_err"] = [], []
    for step in range(FEEDBACK_STEPS):
        g = {k: torch.from_numpy(v) for k, v in _grads(mesh.rank, step).items()}
        mean, err = optim.cross_pod_mean(g, err, pod)
        out["mean"].append({k: v.numpy() for k, v in mean.items()})
        out["mean_err"].append({k: v.numpy() for k, v in err.items()})
        if step == 0:
            plain, same = optim.cross_pod_mean(g, err, pod, compress=False)
            out["plain"] = {k: v.numpy() for k, v in plain.items()}
            out["plain_err_kept"] = all(same[k] is err[k] for k in err)
            out["psum_over_size"] = {k: (pod.psum(v.float()) / pod.size).numpy()
                                     for k, v in g.items()}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{kappa: [per-rank results]}: κ = 2 spawned over gloo, κ = 1 here."""
    one = rank_cases(make_batch_mesh(1, device="cpu"))
    two = spawn_ranks(rank_cases, 2, timeout=SPAWN_TIMEOUT, device="cpu",
                      workdir=tmp_path_factory.mktemp("service_ranks"))
    return {1: one, 2: two}


@pytest.fixture(scope="module")
def reference():
    from repro.core import random_sparse as r_random_sparse
    from repro.serve import DecompositionService as RDecompositionService

    rts = _requests(r_random_sparse)
    out = {}
    for method in METHODS:
        svc = RDecompositionService(R, backend="segment", clock=FakeClock(), **SERVICE)
        out[method] = [f.result() for f in _serve(svc, rts, method)]
    return out


def _bitwise(a, b):
    assert a["iters"] == b["iters"] and a["fits"] == b["fits"]
    assert a["host_syncs"] == b["host_syncs"]
    for Fa, Fb in zip(a["factors"], b["factors"]):
        assert np.array_equal(Fa, Fb)
    assert np.array_equal(a["weights"], b["weights"])


@pytest.mark.parametrize("method", METHODS)
def test_service_on_two_ranks_equals_one_rank_bitwise(ranks, method):
    got, one = ranks[2][0]["service"][method], ranks[1]["service"][method]
    assert len(got) == len(one) == 7
    for a, b in zip(got, one):
        assert a["engine"] == "pod" and a["method"] == method and a["host_syncs"] == 1
        _bitwise(a, b)
    # 5 requests of one class at max_batch 3, 2 of another: three flushes,
    # each served by the follower once.
    assert ranks[2][0]["batches"][method] == ranks[2][1]["service"][method] == 3


@pytest.mark.parametrize("method", METHODS)
def test_service_on_one_rank_matches_reference(ranks, reference, method):
    for g, r in zip(ranks[1]["service"][method], reference[method]):
        assert g["iters"] == r.iters == 4
        np.testing.assert_allclose(g["fits"], r.fits, rtol=0, atol=FIT_ATOL)
        for Fg, Fr in zip(g["factors"], r.factors):
            np.testing.assert_allclose(Fg, Fr, **FACTOR_TOL)


@pytest.mark.parametrize("kappa", [1, 2])
def test_double_buffered_service_is_bitwise_synchronous(ranks, kappa):
    lead = ranks[kappa][0] if kappa == 2 else ranks[1]
    for a, b in zip(lead["double_buffer"], lead["service"]["cp"]):
        _bitwise(a, b)
    if kappa == 2:
        assert ranks[2][1]["double_buffer"] == 3


def test_follower_error_reaches_the_controllers_futures(ranks):
    lead, follower = ranks[2]
    assert "rank 1 failed to prepare the flush" in lead["follower_error"]
    assert "ValueError: follower down" in lead["follower_error"]
    assert lead["after_error"]["iters"] == 2 and lead["after_error"]["engine"] == "pod"
    assert follower["served_after_error"] == 1
    assert "only the controller" in follower["follower_submit"]
    assert lead["follower_submit"] is None
    assert ranks[1]["follower_error"] is None          # one rank: nothing fails


def _reference_means(kappa):
    """The reference's quantizer on the host, each rank's error fed back:
    per step the mean of the ranks' dequantized gradients and each rank's
    residual."""
    from repro import optim as r_optim

    err = [{k: np.zeros(s, np.float32) for k, s in GRAD_SHAPES.items()}
           for _ in range(kappa)]
    means, errs = [], []
    for step in range(FEEDBACK_STEPS):
        deqs = []
        for r in range(kappa):
            g32 = {k: v + err[r][k] for k, v in _grads(r, step).items()}
            deq = {k: np.asarray(r_optim.dequantize(*r_optim.quantize(v)))
                   for k, v in g32.items()}
            err[r] = {k: g32[k] - deq[k] for k in g32}
            deqs.append(deq)
        means.append({k: sum(d[k] for d in deqs) / kappa for k in GRAD_SHAPES})
        errs.append([dict(e) for e in err])
    return means, errs


@pytest.mark.parametrize("kappa", [1, 2])
def test_cross_pod_mean_matches_the_reference_formula(ranks, kappa):
    means, errs = _reference_means(kappa)
    per_rank = ranks[2] if kappa == 2 else [ranks[1]]
    for r, x in enumerate(per_rank):
        for step in range(FEEDBACK_STEPS):
            for k in GRAD_SHAPES:
                np.testing.assert_allclose(x["mean"][step][k], means[step][k],
                                           rtol=0, atol=1e-6)
                np.testing.assert_allclose(x["mean_err"][step][k], errs[step][r][k],
                                           rtol=0, atol=1e-6)
        for k in GRAD_SHAPES:
            assert np.array_equal(x["plain"][k], x["psum_over_size"][k])
            exact = sum(_grads(q, 0)[k] for q in range(kappa)) / kappa
            np.testing.assert_allclose(x["plain"][k], exact, rtol=0, atol=1e-6)
        assert x["plain_err_kept"]
    if kappa == 2:
        for k in GRAD_SHAPES:
            assert np.array_equal(per_rank[0]["mean"][-1][k], per_rank[1]["mean"][-1][k])
