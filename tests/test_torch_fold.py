"""The port's sparse fit, folded into the last mode's MTTKRP, on the CPU.

``<X, X_hat>`` is read off the last mode's MTTKRP output,
``sum_r w_r sum_i F_N[i, r] M_N[i, r]``, instead of a pass over the
nonzeros (``core.als_device._build_folded_fit``).  Held here:

* each sweep's reported fit is ``1 - ||X - X_hat|| / ||X||``, computed in
  float64 from the tensor's nonzeros and that sweep's factors and weights,
  for cp and nncp on every backend, through the fused engine, the batched
  engine (B = 3, padded to one nnz cap) and the distributed sweep over
  κ = 2 gloo ranks (the last-mode MTTKRP is already summed over the mesh,
  so the inner product must not be summed again);
* the fit reads nothing of the fit data but ``norm_x_sq``: a window run
  on fit data whose coordinates are zeros and whose values are NaN gives
  the same fits and factors, bit for bit;
* the ``als.fit`` span says which fit ran (``source``): "mttkrp" for the
  folded fit, "nonzeros" for the masked method's weighted fit.

The file imports nothing of JAX: the κ = 2 ranks re-import it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import als_device
from repro_torch.core.coo import SparseTensor, low_rank_sparse, random_sparse
from repro_torch.core.cpd import cpd_als
from repro_torch.core.distributed import (_collect_dist_data,
                                          cpd_als_distributed,
                                          make_distributed_plan,
                                          shard_slab_mode_data)
from repro_torch.core.mttkrp import make_plan
from repro_torch.launch import spawn_ranks
from repro_torch.methods import get_method
from repro_torch.obs import trace
from repro_torch.serve import BatchedEngine

R = 3
SWEEPS = (1, 2, 3)
FIT_TOL = 1e-6        # a fit below 0.9, against its float64 value
FIT_ATOL = 1e-4       # the CPD tests' own, for the exact-recovery tensor
SHAPES = [((16, 12, 9), 500), ((10, 8, 7, 6), 600)]

DIST_SHAPE, DIST_NNZ, DIST_R = (48, 32, 3), 1500, 4
DIST_CASES = [("cp", "psum"), ("cp", "gather"), ("nncp", "psum"),
              ("cp", "slab")]
SPAWN_TIMEOUT = 240.0


def exact_fit(tensor, factors, weights):
    """``1 - ||X - X_hat||_F / ||X||_F`` in float64, on the dense tensor
    the nonzeros make."""
    dense = np.zeros(tensor.shape)
    np.add.at(dense, tuple(tensor.indices.T.astype(np.int64)),
              tensor.values.astype(np.float64))
    letters = "abcdefgh"[:len(factors)]
    model = np.einsum(",".join(["r"] + [c + "r" for c in letters]) + "->"
                      + letters, np.asarray(weights, np.float64),
                      *[np.asarray(F, np.float64) for F in factors])
    return 1.0 - np.linalg.norm(dense - model) / np.linalg.norm(dense)


def _tensors(shape, nnz, count=1):
    return [low_rank_sparse(shape, nnz - 40 * i, R, seed=i, noise=0.3)[0]
            for i in range(count)]


def _init(method, shape, rank, seed):
    spec = get_method(method)
    init = spec.init_state_host or als_device.init_state_host
    return init(shape, rank, seed)


@pytest.mark.parametrize("method", ["cp", "nncp"])
@pytest.mark.parametrize("backend", ["slab", "segment", "coo"])
@pytest.mark.parametrize("engine", ["fused", "batched"])
@pytest.mark.parametrize("shape,nnz", SHAPES)
def test_folded_fit_is_the_fit(shape, nnz, engine, backend, method):
    tensors = _tensors(shape, nnz, 3 if engine == "batched" else 1)
    for k in SWEEPS:
        if engine == "fused":
            results = [cpd_als(tensors[0], R, backend=backend, n_iters=k,
                               tol=-1.0, seed=7, method=method, device="cpu")]
        else:
            results = BatchedEngine(R, backend=backend, check_every=2,
                                    device="cpu").decompose_batch(
                tensors, n_iters=k, tol=-1.0, seeds=[7, 8, 9], method=method)
        for t, res in zip(tensors, results):
            assert res.iters == len(res.fits) == k
            want = exact_fit(t, res.factors, res.weights)
            assert 0.0 < want < 0.9
            assert abs(res.fits[-1] - want) <= FIT_TOL


def test_folded_fit_on_the_exact_recovery_tensor():
    """The fully observed rank-4 tensor ``chip_smoke.py`` recovers (96 x 80
    x 64, seed 0): at a fit of 0.999 the float32 ``|X|^2 - 2<X, X_hat> +
    |X_hat|^2`` cancels most; the folded fit stays within the CPD tests'
    tolerance of the float64 fit."""
    shape, rank = (96, 80, 64), 4
    rng = np.random.default_rng(0)
    F = [rng.standard_normal((I, rank)).astype(np.float32) for I in shape]
    dense = np.einsum("ir,jr,kr->ijk", *F)
    idx = np.indices(shape).reshape(len(shape), -1).T.astype(np.int32)
    t = SparseTensor(idx, dense.reshape(-1).astype(np.float32), shape)
    res = cpd_als(t, rank, backend="slab", n_iters=50, kappa=4, tol=1e-9,
                  device="cpu")
    want = exact_fit(t, res.factors, res.weights)
    assert want >= 0.999 and res.fits[-1] >= 0.999
    assert abs(res.fits[-1] - want) <= FIT_ATOL


def dist_rank_cases(mesh):
    """On this rank: the distributed sweep's state and fit after 1, 2 and 3
    sweeps from one start, per case (segment psum and gather, nncp, and the
    slab kernel's branch with a mesh)."""
    t = random_sparse(DIST_SHAPE, DIST_NNZ, seed=5, distribution="powerlaw")
    out = {}
    for method, coll in DIST_CASES:
        if coll == "slab":
            plan = make_distributed_plan(t, mesh, device="cpu")
            md, meta = shard_slab_mode_data(plan, DIST_R)
            _, fit_data = _collect_dist_data(plan)
            window = als_device._build_sweep_block(
                "slab", len(DIST_SHAPE), DIST_R, DIST_SHAPE, meta, "inv", 1,
                method, mesh)
            state = als_device.init_state(DIST_SHAPE, DIST_R, 2, device="cpu")
            for k in SWEEPS:
                state, fits, _ = window(state, md, fit_data)
                out[(method, coll, k)] = (
                    float(fits[-1]), [F.numpy() for F in state[0]],
                    state[2].numpy())
            continue
        plan = make_distributed_plan(t, mesh, method=method)
        for k in SWEEPS:
            res = cpd_als_distributed(t, DIST_R, plan=plan, n_iters=k,
                                      tol=-1.0, seed=2, method=method,
                                      collective=coll)
            out[(method, coll, k)] = (res.fits[-1], res.factors, res.weights)
    return out


@pytest.fixture(scope="module")
def dist_ranks(tmp_path_factory):
    return spawn_ranks(dist_rank_cases, 2, timeout=SPAWN_TIMEOUT,
                       device="cpu",
                       workdir=tmp_path_factory.mktemp("fold_ranks"))


@pytest.mark.parametrize("method,collective", DIST_CASES)
def test_folded_fit_over_two_ranks_is_the_fit(dist_ranks, method, collective):
    t = random_sparse(DIST_SHAPE, DIST_NNZ, seed=5, distribution="powerlaw")
    for k in SWEEPS:
        got = [r[(method, collective, k)] for r in dist_ranks]
        fit, factors, weights = got[0]
        assert got[1][0] == fit                 # the same on both ranks
        want = exact_fit(t, factors, weights)
        assert 0.0 < want < 0.9
        assert abs(fit - want) <= FIT_TOL


@pytest.mark.parametrize("method", ["cp", "nncp"])
@pytest.mark.parametrize("backend", ["slab", "segment", "coo"])
def test_fit_reads_no_nonzeros(backend, method):
    """A window's fits and state are the same, bit for bit, on fit data
    whose index columns are zeros and whose values are NaN."""
    t = _tensors((16, 12, 9), 500)[0]
    plan = make_plan(t, 1, device="cpu")
    mode_data, meta = als_device._collect_mode_data(plan, backend, R)
    window = als_device._build_sweep_block(backend, t.nmodes, R, t.shape,
                                           meta, "inv", 3, method)
    idx_cols, values, norm_x_sq = als_device.make_fit_data(t, "cpu")
    blind = (tuple(torch.zeros_like(c) for c in idx_cols),
             torch.full_like(values, float("nan")), norm_x_sq)
    start = als_device.state_from_reference(
        *_init(method, t.shape, R, 3), device="cpu")
    st_a, fits_a, _ = window(start, mode_data,
                             (idx_cols, values, norm_x_sq))
    st_b, fits_b, _ = window(start, mode_data, blind)
    assert bool(torch.isfinite(fits_a).all())
    assert torch.equal(fits_a, fits_b)
    for a, b in zip(st_a[0] + st_a[1] + (st_a[2],),
                    st_b[0] + st_b[1] + (st_b[2],)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method,source", [("cp", "mttkrp"),
                                           ("nncp", "mttkrp"),
                                           ("masked", "nonzeros")])
@pytest.mark.parametrize("engine", ["fused", "batched"])
def test_fit_span_names_its_source(engine, method, source):
    tensors = _tensors((16, 12, 9), 500, 3 if engine == "batched" else 1)
    kw = {}
    if method == "masked":
        kw["weights"] = [np.random.default_rng(i).uniform(0.2, 1.0, t.nnz)
                         .astype(np.float32) for i, t in enumerate(tensors)]
    with trace.capture() as tr:
        if engine == "fused":
            cpd_als(tensors[0], R, n_iters=3, check_every=2, tol=-1.0,
                          method=method, device="cpu",
                          weights=kw.get("weights", [None])[0])
        else:
            BatchedEngine(R, check_every=2, device="cpu").decompose_batch(
                tensors, n_iters=3, tol=-1.0, method=method, **kw)
    fits = [r for r in tr.records()
            if r["kind"] == "span" and r["name"] == "als.fit"]
    assert len(fits) == 3
    assert all(r["args"]["source"] == source for r in fits)
