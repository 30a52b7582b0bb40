"""Port vs JAX package: the decomposition methods on the CPU.

The same tensors, weights and seeded inits go through the reference
``repro.core.cpd_als(method=...)`` and the port's, on each of the port's
backends (``slab`` runs the kernel's plain version on the CPU).  The
reference runs ``segment``, and ``pallas`` in interpret mode in one case,
as its own tests do.  Tolerances as in ``test_torch_cpd.py``: fits within
1e-4 absolute, factors within rtol 1e-3 / atol 1e-5 (both solve in
float32 but sum the MTTKRP and the fit in another order).  The port's own
invariants are held bitwise where its arithmetic does not change.
All cases are seeded ``parametrize``; nothing here draws examples.
"""
import numpy as np
import pytest
import torch

from repro.core import cpd_als as r_cpd_als
from repro.core import random_sparse as r_random_sparse
from repro.core import SparseTensor as RSparseTensor
from repro.core.als_device import normalize_entry_weights as r_normalize
from repro.kernels import ref as r_ref
from repro.methods.nncp import init_state_host_nonneg as r_nonneg_init
from repro_torch import methods
from repro_torch.core import als_device
from repro_torch.core.coo import SparseTensor, random_sparse
from repro_torch.core.cpd import cpd_als
from repro_torch.core.mttkrp import make_plan
from repro_torch.kernels import mttkrp_slab as ks
from repro_torch.kernels import ref as t_ref
from repro_torch.methods.nncp import init_state_host_nonneg

FIT_ATOL = 1e-4
FACTOR_TOL = dict(rtol=1e-3, atol=1e-5)
MONO_SLACK = 1e-5      # float32 wobble allowed in "the fit never falls"
CASES = [((16, 12, 9), 380, 3), ((10, 8, 7, 6), 420, 4)]
BACKENDS = ["slab", "segment", "coo"]


def _pair(shape, nnz, seed, nonneg=False):
    r = r_random_sparse(shape, nnz, seed=seed, distribution="powerlaw")
    t = random_sparse(shape, nnz, seed=seed, distribution="powerlaw")
    if nonneg:
        r = RSparseTensor(r.indices, np.abs(r.values) + 0.1, r.shape)
        t = SparseTensor(t.indices, np.abs(t.values) + 0.1, t.shape)
    return r, t


def _weights(nnz, seed):
    return np.random.default_rng(seed + 100).uniform(0.25, 1.75, nnz).astype(
        np.float32)


def _assert_same_run(port, ref):
    assert port.iters == ref.iters and port.host_syncs == ref.host_syncs
    assert port.method == ref.method
    np.testing.assert_allclose(port.fits, ref.fits, rtol=0, atol=FIT_ATOL)
    for a, b in zip(port.factors, ref.factors):
        np.testing.assert_allclose(a, b, **FACTOR_TOL)
    np.testing.assert_allclose(port.weights, ref.weights, rtol=1e-3)


@pytest.mark.parametrize("shape,nnz,rank", CASES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", ["nncp", "masked"])
def test_method_matches_reference(method, backend, shape, nnz, rank):
    r, t = _pair(shape, nnz, seed=rank, nonneg=method == "nncp")
    kw = dict(n_iters=4, check_every=2, kappa=2, tol=-1.0, seed=3,
              method=method)
    if method == "masked":
        kw["weights"] = _weights(nnz, rank)
    ref = r_cpd_als(r, rank, backend="segment", **kw)
    port = cpd_als(t, rank, backend=backend, device="cpu", **kw)
    _assert_same_run(port, ref)


@pytest.mark.parametrize("method", ["nncp", "masked"])
def test_slab_matches_reference_pallas(method):
    """The port's slab backend against the reference's Pallas kernel in
    interpret mode (the valued entry for 'masked')."""
    r, t = _pair((12, 9, 7), 260, seed=9, nonneg=method == "nncp")
    kw = dict(n_iters=2, check_every=2, kappa=2, tol=-1.0, seed=1,
              method=method)
    ref = r_cpd_als(r, 3, backend="pallas", **kw)
    port = cpd_als(t, 3, backend="slab", device="cpu", **kw)
    _assert_same_run(port, ref)


def test_nonneg_init_bitwise():
    for shape, rank, seed in [((16, 12, 9), 4, 0), ((7, 5, 3, 2), 6, 11)]:
        a, b = r_nonneg_init(shape, rank, seed), init_state_host_nonneg(
            shape, rank, seed)
        for x, y in zip(a[0] + a[1] + (a[2],), b[0] + b[1] + (b[2],)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_nncp_nonnegative_and_fit_never_falls(backend, seed):
    _, t = _pair((16, 12, 9), 380, seed, nonneg=True)
    res = cpd_als(t, 4, n_iters=8, tol=-1.0, check_every=2, seed=seed,
                  backend=backend, method="nncp", device="cpu")
    for F in res.factors:
        assert (F >= 0.0).all()
    assert (res.weights >= 0.0).all()
    for a, b in zip(res.fits, res.fits[1:]):
        assert b >= a - MONO_SLACK, (a, b)


def _drop_case(seed, ndrop):
    _, t = _pair((16, 12, 9), 300, seed)
    w = _weights(t.nnz, seed)
    drop = np.random.default_rng(seed).choice(t.nnz, size=ndrop, replace=False)
    keep = np.ones(t.nnz, bool)
    keep[drop] = False
    w0 = w.copy()
    w0[drop] = 0.0
    return t, w, w0, keep


@pytest.mark.parametrize("backend,seed,ndrop", [
    ("segment", 0, 1), ("segment", 2, 9), ("coo", 1, 1), ("coo", 3, 24)])
def test_weight0_equals_absent_bitwise(backend, seed, ndrop):
    """A weight-0 entry gives a residual of +-0.0, which the segment and
    coo MTTKRPs add as nothing, in an order the deletion does not change:
    the factors are bitwise those of the tensor without the entry."""
    t, w, w0, keep = _drop_case(seed, ndrop)
    kw = dict(n_iters=4, tol=-1.0, check_every=2, method="masked",
              backend=backend, kappa=2, device="cpu")
    a = cpd_als(t, 3, weights=w0, **kw)
    b = cpd_als(SparseTensor(t.indices[keep], t.values[keep], t.shape), 3,
                weights=w[keep], **kw)
    for Fa, Fb in zip(a.factors, b.factors):
        assert np.array_equal(Fa, Fb)
    np.testing.assert_allclose(a.fits, b.fits, rtol=0, atol=1e-6)


def test_weight0_equals_absent_on_slab():
    """On the slab backend deleting an interior entry moves later entries
    to other slots, so chunks sum in another order: within 1e-6."""
    t, w, w0, keep = _drop_case(5, 9)
    kw = dict(n_iters=4, tol=-1.0, check_every=2, method="masked",
              backend="slab", kappa=2, device="cpu")
    a = cpd_als(t, 3, weights=w0, **kw)
    b = cpd_als(SparseTensor(t.indices[keep], t.values[keep], t.shape), 3,
                weights=w[keep], **kw)
    for Fa, Fb in zip(a.factors, b.factors):
        np.testing.assert_allclose(Fa, Fb, rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.fits, b.fits, rtol=0, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_weights_of_ones_equal_unweighted(backend):
    _, t = _pair((16, 12, 9), 300, 4)
    kw = dict(n_iters=4, tol=-1.0, check_every=2, method="masked",
              backend=backend, device="cpu")
    a = cpd_als(t, 3, weights=np.ones(t.nnz, np.float32), **kw)
    b = cpd_als(t, 3, **kw)
    for Fa, Fb in zip(a.factors, b.factors):
        assert np.array_equal(Fa, Fb)
    assert a.fits == b.fits


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0])
def test_weight_normalization_equals_reference(scale):
    w = _weights(200, 7) * np.float32(scale)
    got = als_device.normalize_entry_weights(
        als_device.validate_entry_weights(200, w))
    want = r_normalize(w)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert float(got.max()) <= 1.0 or scale <= 1.0 / 1.75
    assert np.array_equal(als_device.normalize_entry_weights(got), got)


def test_weights_are_validated():
    _, t = _pair((16, 12, 9), 200, 0)
    with pytest.raises(ValueError, match="align"):
        cpd_als(t, 3, method="masked", weights=np.ones(5), device="cpu")
    with pytest.raises(ValueError, match="nonnegative"):
        cpd_als(t, 3, method="masked", weights=-np.ones(t.nnz), device="cpu")
    with pytest.raises(ValueError, match="weighted-fit"):
        cpd_als(t, 3, method="nncp", weights=np.ones(t.nnz), device="cpu")
    with pytest.raises(ValueError, match="host"):
        cpd_als(t, 3, method="nncp", engine="host", device="cpu")


def test_registry_lists_the_methods():
    from repro.methods import list_methods as r_list_methods

    assert methods.list_methods() == ["cp", "masked", "nncp", "streaming"]
    assert methods.list_methods() == r_list_methods()
    assert methods.batchable_methods() == ["cp", "masked", "nncp"]
    assert methods.get_method("streaming").stateful
    masked = methods.get_method("masked")
    assert masked.valued_mode_data and masked.weighted_fit
    assert not methods.get_method("nncp").valued_mode_data
    with pytest.raises(KeyError, match="registered"):
        methods.get_method("nope")
    with pytest.raises(ValueError, match="already"):
        methods.register_method(methods.MethodSpec(name="cp"))


def _plain_valued(p, vals_layout, in_f):
    arrays = [torch.as_tensor(a) for a in (p.idx_packed, p.lrows_packed,
                                           p.rb_of)]
    return ks.mttkrp_slab_valued(
        arrays[0], vals_layout, torch.as_tensor(p.val_scatter.astype(np.int64)),
        arrays[1], arrays[2], in_f, chunks=None,
        num_row_blocks=p.num_row_blocks, block_rows=p.block_rows, tile=p.tile)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_valued_slab_with_signed_zero_residuals(mode):
    """Residuals that are exactly +0.0 or -0.0 (weight-0 entries) add
    nothing: the valued slab entry equals its plain version on the
    segment layout, and equals the run with those entries deleted."""
    t = random_sparse((20, 14, 9), 400, seed=mode, distribution="powerlaw")
    plan = make_plan(t, 2, block_rows=8, tile=32, device="cpu")
    lay, p = plan.layouts[mode], plan.packed(mode)
    rng = np.random.default_rng(mode)
    F = [torch.as_tensor(rng.standard_normal((I, 4)).astype(np.float32))
         for I in t.shape]
    in_f = [F[w] for w in lay.input_modes()]
    vals = rng.standard_normal(t.nnz).astype(np.float32)
    zero = rng.choice(t.nnz, size=60, replace=False)
    vals[zero[:30]] = 0.0
    vals[zero[30:]] = -0.0
    vals_layout = torch.as_tensor(vals[lay.perm])
    got = _plain_valued(p, vals_layout, in_f)[: lay.num_rows]
    seg = t_ref.mttkrp_sorted_segments(
        torch.as_tensor(lay.indices[:, lay.input_modes()]),
        torch.as_tensor(lay.rows), vals_layout, in_f, lay.num_rows)
    assert torch.equal(got, seg)
    # The slots of the zero residuals hold exactly +-0.0, so skipping them
    # (as the kernel does) changes nothing.
    keep = vals[lay.perm] != 0.0
    slots = torch.as_tensor(p.val_scatter.astype(np.int64))
    packed = ks.scatter_slab_values(vals_layout, slots, p.num_slabs * p.tile)
    assert torch.count_nonzero(packed) == int(keep.sum())


def test_masked_residual_oracle_matches_reference():
    rt, t = _pair((14, 11, 9), 300, 2)
    rng = np.random.default_rng(3)
    F = [rng.standard_normal((I, 3)).astype(np.float32) for I in t.shape]
    lam = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    ew = _weights(t.nnz, 3)
    ew[:20] = 0.0
    for d in range(3):
        want = np.asarray(r_ref.mttkrp_masked_residual(
            rt.indices, rt.values, ew, F, lam, d, t.shape[d]))
        got = t_ref.mttkrp_masked_residual(
            torch.as_tensor(t.indices), torch.as_tensor(t.values),
            torch.as_tensor(ew), [torch.as_tensor(f) for f in F],
            torch.as_tensor(lam), d, t.shape[d]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    model = t_ref.cp_model_at_coords(torch.as_tensor(t.indices),
                                     [torch.as_tensor(f) for f in F],
                                     torch.as_tensor(lam)).numpy()
    np.testing.assert_allclose(
        model, np.asarray(r_ref.cp_model_at_coords(rt.indices, F, lam)),
        rtol=1e-5, atol=1e-5)


def test_masked_completion_beats_plain_on_heldout():
    """EM over observed entries imputes held-out entries of a low-rank
    tensor: the masked method's held-out error is below a third of plain
    CP's (which treats missing entries as zeros of the fit)."""
    rng = np.random.default_rng(0)
    shape, rank = (12, 10, 8), 2
    Fs = [rng.standard_normal((I, rank)).astype(np.float32) for I in shape]
    full = np.einsum("ir,jr,kr->ijk", *Fs)
    coords = np.indices(shape).reshape(3, -1).T.astype(np.int32)
    order = rng.permutation(len(coords))
    obs, held = coords[order[:600]], coords[order[600:]]
    t = SparseTensor(obs, full[tuple(obs.T)].astype(np.float32), shape)
    truth = full[tuple(held.T)]
    errs = {}
    for method in ("masked", "cp"):
        res = cpd_als(t, rank, method=method, n_iters=60, tol=1e-9,
                      check_every=10, backend="slab", device="cpu")
        errs[method] = np.linalg.norm(res.reconstruct_at(held) - truth)
    assert errs["masked"] < errs["cp"] / 3, errs
