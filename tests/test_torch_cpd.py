"""Port vs JAX package: CPD-ALS end to end on the CPU.

The same tensor and the same seeded init go through the reference
``repro.core.cpd_als(backend="segment")`` and the port's ``cpd_als`` on
each of its backends (``slab`` runs the kernel's plain version on the
CPU).  Tolerances: fits within 1e-4 absolute and factors within rtol 1e-3
(atol 1e-5): both solve in float32 with the same LU-inverse solver on the
CPU, but sum the MTTKRP and the fit in another order.  ``host_syncs``
must be equal.
"""
import numpy as np
import pytest
import torch

from repro.core import cpd_als as r_cpd_als
from repro.core.als_device import init_state_host as r_init
from repro.core.coo import SparseTensor as RSparseTensor
from repro.core.coo import low_rank_sparse as r_low_rank_sparse
from repro_torch.convert import state_from_reference, state_to_host
from repro_torch.core import als_device
from repro_torch.core.coo import SparseTensor, low_rank_sparse
from repro_torch.core.cpd import cpd_als
from repro_torch.core.distributed import cpd_als_distributed
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs import trace as obs_trace

FIT_ATOL = 1e-4
FACTOR_TOL = dict(rtol=1e-3, atol=1e-5)

CASES = [((16, 12, 9), 500, 3), ((40, 7, 33, 5), 1500, 5),
         ((9, 6, 5, 4, 3), 400, 8)]


def _tensors(shape, nnz, rank, seed=0):
    r, _ = r_low_rank_sparse(shape, nnz, rank, seed=seed, noise=0.05)
    t, _ = low_rank_sparse(shape, nnz, rank, seed=seed, noise=0.05)
    return r, t


def _assert_same_run(port, ref):
    assert port.iters == ref.iters
    assert port.host_syncs == ref.host_syncs
    np.testing.assert_allclose(port.fits, ref.fits, rtol=0, atol=FIT_ATOL)
    for a, b in zip(port.factors, ref.factors):
        np.testing.assert_allclose(a, b, **FACTOR_TOL)
    np.testing.assert_allclose(port.weights, ref.weights, rtol=1e-3)


@pytest.mark.parametrize("shape,nnz,rank", CASES)
@pytest.mark.parametrize("backend", ["slab", "segment", "coo"])
def test_fused_matches_reference(shape, nnz, rank, backend):
    r, t = _tensors(shape, nnz, rank)
    ref = r_cpd_als(r, rank, backend="segment", n_iters=5, check_every=2,
                    kappa=4, tol=-1.0)
    port = cpd_als(t, rank, backend=backend, n_iters=5, check_every=2,
                   kappa=4, tol=-1.0, device="cpu")
    assert port.engine == "fused" and port.host_syncs == 4
    _assert_same_run(port, ref)


@pytest.mark.parametrize("backend", ["slab", "segment"])
def test_host_engine_matches_reference(backend):
    r, t = _tensors((20, 14, 10), 700, 4, seed=1)
    ref = r_cpd_als(r, 4, backend="segment", engine="host", n_iters=4,
                    kappa=2, tol=-1.0)
    port = cpd_als(t, 4, backend=backend, engine="host", n_iters=4, kappa=2,
                   tol=-1.0, device="cpu")
    assert port.engine == "host"
    _assert_same_run(port, ref)


def test_convergence_break_matches_reference():
    r, t = _tensors((18, 14, 10), 600, 3, seed=7)
    ref = r_cpd_als(r, 3, n_iters=30, kappa=2, tol=1e-4, check_every=1)
    port = cpd_als(t, 3, n_iters=30, kappa=2, tol=1e-4, check_every=1,
                   device="cpu")
    assert port.iters == ref.iters and port.host_syncs == ref.host_syncs
    np.testing.assert_allclose(port.fits, ref.fits, atol=FIT_ATOL)


def test_warm_start_from_reference_state():
    r, t = _tensors((16, 12, 9), 500, 3, seed=2)
    ref = r_cpd_als(r, 3, n_iters=3, tol=-1.0, seed=4)
    host = r_init(t.shape, 3, 4)
    port = cpd_als(t, 3, n_iters=3, tol=-1.0, init_state=host, device="cpu")
    _assert_same_run(port, ref)


def test_state_from_reference_round_trips():
    host = r_init((16, 12, 9), 5, 3)
    state = state_from_reference(*host, device="cpu")
    back = state_to_host(state)
    for a, b in zip(host[0] + host[1] + (host[2],),
                    back[0] + back[1] + (back[2],)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # From a CPDResult: grams are recomputed from the factors.
    r, _ = _tensors((16, 12, 9), 500, 3, seed=5)
    res = r_cpd_als(r, 3, n_iters=2, tol=-1.0)
    state = state_from_reference(res.factors, None, res.weights, device="cpu")
    for F, G in zip(res.factors, state[1]):
        np.testing.assert_array_equal(G.numpy(), F.T @ F)
    assert state[2].dtype == torch.float32


def _low_rank_full(cls, shape, rank, seed):
    rng = np.random.default_rng(seed)
    F = [rng.standard_normal((I, rank)).astype(np.float32) for I in shape]
    dense = np.einsum("ir,jr,kr->ijk", *F)
    idx = np.indices(shape).reshape(len(shape), -1).T.astype(np.int32)
    return cls(idx, dense.reshape(-1).astype(np.float32), shape)


def test_exact_recovery_of_the_chip_smoke_tensor():
    """The fully observed rank-4 tensor ``chip_smoke.py`` recovers on the
    card (96 x 80 x 64, seed 0) reaches a fit of at least 0.999 within 50
    iterations, as in the reference's host loop.  (The reference's fused
    engine reads 0.974 on it: its float32 fit, ``|X|^2 - 2<X, X_hat> +
    |X_hat|^2`` over 491,520 entries, loses that much to cancellation; the
    host loop computes the fit in float64.)"""
    shape, rank = (96, 80, 64), 4
    ref = r_cpd_als(_low_rank_full(RSparseTensor, shape, rank, 0), rank,
                    engine="host", n_iters=50, kappa=4, tol=1e-9)
    port = cpd_als(_low_rank_full(SparseTensor, shape, rank, 0), rank,
                   backend="slab", n_iters=50, kappa=4, tol=1e-9, device="cpu")
    assert ref.fits[-1] >= 0.999 and port.fits[-1] >= 0.999
    assert abs(port.fits[-1] - ref.fits[-1]) <= FIT_ATOL


def test_window_cache_reused_for_same_shape():
    _, t1 = _tensors((22, 14, 9), 500, 3, seed=4)
    _, t2 = _tensors((22, 14, 9), 500, 3, seed=5)
    cpd_als(t1, 3, n_iters=2, tol=-1.0, device="cpu")
    before = als_device.sweep_cache_stats()
    cpd_als(t2, 3, n_iters=2, tol=-1.0, device="cpu")
    after = als_device.sweep_cache_stats()
    assert after["currsize"] == before["currsize"]
    assert after["hits"] == before["hits"] + 1


def _one_rank_distributed(t, rank, **kw):
    mesh = make_mesh((1,), ("sm",), device="cpu")
    return cpd_als_distributed(t, rank, mesh, **kw)


@pytest.mark.parametrize("engine", [cpd_als, _one_rank_distributed],
                         ids=["fused", "distributed"])
def test_rescue_window_reruns_with_pinv(monkeypatch, engine):
    """A window whose solve reports failure is run again from its starting
    state with the pinv rescue: one extra host sync, and (the system being
    well conditioned) the same fits as the plain solve.  The fused and the
    distributed engine share the window loop that does it."""
    _, t = _tensors((17, 12, 9), 500, 3, seed=6)
    kw = dict(n_iters=4, check_every=2, tol=-1.0, device="cpu")
    plain = engine(t, 3, **kw)
    real = als_device._build_solver
    calls = []

    def failing_once(rank, solver):
        solve = real(rank, solver)

        def solve_flagged(M, V):
            Yd, ok, Vr = solve(M, V)
            calls.append(1)
            return Yd, ok & (len(calls) != 1), Vr

        return solve_flagged

    monkeypatch.setattr(als_device, "_build_solver", failing_once)
    als_device._build_sweep_block.cache_clear()
    try:
        res = engine(t, 3, **kw)
    finally:
        als_device._build_sweep_block.cache_clear()
    assert calls
    assert res.host_syncs == plain.host_syncs + 1
    np.testing.assert_allclose(res.fits, plain.fits, atol=FIT_ATOL)


def test_profile_mttkrp_and_solver_choice():
    """Each mode's MTTKRP and update is a span of its own in every sweep,
    and each sweep's fit one; and the solver choice."""
    _, t = _tensors((16, 12, 9), 500, 3, seed=8)
    with obs_trace.capture() as tr:
        res = als_device.cpd_als_fused(t, 3, n_iters=2, tol=-1.0,
                                       device="cpu")
    spans = [r for r in tr.records() if r["kind"] == "span"]
    mttkrp = [r["args"]["mode"] for r in spans if r["name"] == "als.mttkrp"]
    assert mttkrp == [0, 1, 2] * 2
    assert [r["args"]["mode"] for r in spans
            if r["name"] == "als.update"] == [0, 1, 2] * 2
    assert sum(r["name"] == "als.fit" for r in spans) == res.iters == 2
    assert res.mttkrp_seconds == 0.0
    assert als_device.resolve_solver("auto", "cpu") == "inv"
    assert als_device.resolve_solver("auto", "cuda") == "cho"
    cho = als_device.cpd_als_fused(t, 3, n_iters=2, tol=-1.0, solver="cho",
                                   device="cpu")
    np.testing.assert_allclose(cho.fits, res.fits, atol=FIT_ATOL)


def test_cuda_is_asked_for_by_default():
    """Entry points default to the card and raise without it; only an
    explicit device='cpu' runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, t = _tensors((16, 12, 9), 500, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        cpd_als(t, 3, n_iters=1)
