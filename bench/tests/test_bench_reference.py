"""The reference's sweep and fit against a dense NumPy CP-ALS."""
import numpy as np
import torch

from bench.reference import cp_als as ref


def khatri_rao(mats):
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out


def dense_sweep(X, factors):
    """One dense CP-ALS sweep (unfolding times Khatri-Rao, the ridge
    normal equations) and its fit, in float64."""
    N, R = X.ndim, factors[0].shape[1]
    F = [f.astype(np.float64).copy() for f in factors]
    lam = np.ones(R)
    for d in range(N):
        others = [w for w in range(N) if w != d]
        Xd = np.moveaxis(X, d, 0).reshape(X.shape[d], -1)
        M = Xd @ khatri_rao([F[w] for w in others])
        V = np.ones((R, R))
        for w in others:
            V *= F[w].T @ F[w]
        V = V + 1e-10 * max(np.trace(V) / R, 1.0) * np.eye(R)
        Y = np.linalg.solve(V, M.T).T
        lam = np.linalg.norm(Y, axis=0)
        lam = np.where(lam > 1e-12, lam, 1.0)
        F[d] = Y / lam
    model = np.einsum("r,ir,jr,kr->ijk", lam, *F)
    fit = 1 - np.linalg.norm(X - model) / np.linalg.norm(X)
    return F, lam, fit


def sparse_of(X, keep):
    idx = np.argwhere(keep)
    return idx, X[tuple(idx.T)]


def test_one_sweep_matches_dense_numpy():
    rng = np.random.default_rng(0)
    shape, R = (6, 5, 4), 3
    X = rng.standard_normal(shape) * (rng.random(shape) < 0.5)
    idx, vals = sparse_of(X, X != 0)
    init = [rng.standard_normal((I, R)) for I in shape]
    F, w, fits = ref.cp_als(torch.as_tensor(idx), torch.as_tensor(vals),
                            shape, init, 1)
    dF, dw, dfit = dense_sweep(X, init)
    for a, b in zip(F, dF):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(w.numpy(), dw, rtol=1e-9)
    assert abs(float(fits[0]) - dfit) < 1e-10


def test_fit_is_not_fooled_by_cancellation():
    # Every coordinate of an exactly rank-2 tensor, started at its factors:
    # the fit is 1 - 1e-8 or closer, as the dense residual says; a float32
    # identity (the program's fused fit) cancels to far less near 1.
    rng = np.random.default_rng(1)
    shape, R = (40, 30, 30), 2
    true = [rng.standard_normal((I, R)) for I in shape]
    X = np.einsum("ir,jr,kr->ijk", *true)
    idx, vals = sparse_of(X, np.ones(shape, bool))
    F, w, fits = ref.cp_als(torch.as_tensor(idx), torch.as_tensor(vals),
                            shape, true, 2)
    model = np.einsum("r,ir,jr,kr->ijk", w.numpy(), *[f.numpy() for f in F])
    dense_fit = 1 - np.linalg.norm(X - model) / np.linalg.norm(X)
    assert dense_fit > 1 - 1e-9
    assert abs(float(fits[-1]) - dense_fit) < 1e-7


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 2 ** -11 + 2 ** -13,
                      -3.0, float("inf")], dtype=torch.float32)
    got = ref.round_tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10, -3.0,
                            float("inf")]


def test_control_lands_farther_than_float32_rounding():
    rng = np.random.default_rng(2)
    shape, R = (30, 20, 10), 4
    X = rng.standard_normal(shape) * (rng.random(shape) < 0.3)
    idx, vals = sparse_of(X, X != 0)
    init = [rng.standard_normal((I, R)) for I in shape]
    i, v = torch.as_tensor(idx), torch.as_tensor(vals)
    F64, _, _ = ref.cp_als(i, v, shape, init, 5)
    F32, _, _ = ref.cp_als(i, v, shape, init, 5, precision="tf32")
    gap = max(float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))
              for a, b in zip(F32, F64))
    assert gap > 1e-5
