"""Port vs JAX package: the CPD-factorized embedding
(``repro_torch.models.factorized_embed``) on the CPU, at the sizes of
``tests/models/test_factorized_embed.py``.

The factors come from the reference's own initialiser (``build_params``
on ``cpd_embed_specs``) and reach the port through
``convert.params_from_reference``; tokens and upstream gradients come
from numpy seeds.  The lookup and the dense table are held to rtol 1e-5,
atol 1e-6.  ``grad_factors_mttkrp`` with the port's ``segment`` and
``slab`` backends (on the CPU the kernel's plain version) is held against
the reference's ``jax.grad`` of ``sum(lookup * dY)`` and against the
reference's ``grad_factors_mttkrp(backend="segment")`` at the reference
test's own 2e-4, and against torch's autograd on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import factorized_embed as r_fe
from repro.models.common import build_params as r_build_params
from repro_torch.convert import params_from_reference
from repro_torch.models import factorized_embed as fe

BACKENDS = ["segment", "slab"]
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _params(V, d, R, seed):
    rp = r_build_params(r_fe.cpd_embed_specs(V, d, R), jax.random.PRNGKey(seed),
                        jnp.float32)
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")


def _batch(V, d, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, (B, S)).astype(np.int32)
    dY = rng.standard_normal((B, S, d)).astype(np.float32)
    return toks, dY


@pytest.mark.parametrize("V", [30, 60, 97, 152_064])
def test_factor_vocab_specs_and_compression_match_reference(V):
    assert fe.factor_vocab(V) == r_fe.factor_vocab(V)
    assert fe.compression_ratio(V, 2560, 256) == r_fe.compression_ratio(V, 2560, 256)
    specs, ref = fe.cpd_embed_specs(V, 16, 4), r_fe.cpd_embed_specs(V, 16, 4)
    for k in ("A", "B", "C"):
        assert (specs[k].shape, specs[k].axes, specs[k].init, specs[k].scale) == (
            ref[k].shape, ref[k].axes, ref[k].init, ref[k].scale)


def test_compression_ratio():
    assert fe.compression_ratio(152_064, 2560, 256) > 100
    V1, V2 = fe.factor_vocab(152_064)
    assert (V1, V2) == (390, 390) and V1 * V2 >= 152_064


@pytest.mark.parametrize("V,d,R,B,S", [(97, 16, 6, 3, 11), (60, 8, 4, 2, 13)])
def test_lookup_and_table_match_reference(V, d, R, B, S):
    rp, tp = _params(V, d, R, seed=0)
    toks, _ = _batch(V, d, B, S, seed=1)
    ref = np.asarray(r_fe.cpd_embed_lookup(rp, jnp.asarray(toks), V))
    got = fe.cpd_embed_lookup(tp, torch.as_tensor(toks), V)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    table = fe.dense_table(tp, V)
    assert tuple(table.shape) == (V, d)
    np.testing.assert_allclose(table.numpy(), np.asarray(r_fe.dense_table(rp, V)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(table[torch.as_tensor(toks).long()].numpy(),
                               got.numpy(), rtol=1e-5, atol=1e-6)
    i1, i2 = fe.split_ids(torch.as_tensor(toks), V)
    r1, r2 = r_fe.split_ids(jnp.asarray(toks), V)
    assert np.array_equal(i1.numpy(), np.asarray(r1))
    assert np.array_equal(i2.numpy(), np.asarray(r2))


def test_batch_sparse_tensor_is_bitwise_the_reference():
    toks, _ = _batch(97, 4, 3, 13, seed=2)
    ref = r_fe.batch_as_sparse_tensor(toks, 97)
    for got in (fe.batch_as_sparse_tensor(toks, 97),
                fe.batch_as_sparse_tensor(torch.as_tensor(toks), 97)):
        assert got.shape == ref.shape
        assert got.indices.dtype == np.int32
        assert np.array_equal(got.indices, ref.indices)
        assert np.array_equal(got.values, ref.values)


@pytest.mark.parametrize("backend", BACKENDS)
def test_grad_equals_mttkrp(backend):
    """The port's B1f gradient against the reference's autodiff of the
    embedding loss and its MTTKRP engine, and against torch's autograd."""
    V, d, R, B, S = 60, 8, 4, 2, 13
    rp, tp = _params(V, d, R, seed=2)
    toks, dY = _batch(V, d, B, S, seed=3)

    def loss(pp):
        return jnp.sum(r_fe.cpd_embed_lookup(pp, jnp.asarray(toks), V) * dY)

    auto = jax.grad(loss)(rp)
    rA, rB = r_fe.grad_factors_mttkrp(rp, jnp.asarray(toks), jnp.asarray(dY), V,
                                      kappa=4, backend="segment")
    dA, dB = fe.grad_factors_mttkrp(tp, torch.as_tensor(toks), torch.as_tensor(dY), V,
                                    kappa=4, backend=backend)
    for got, ref in ((dA, auto["A"]), (dB, auto["B"]), (dA, rA), (dB, rB)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    (fe.cpd_embed_lookup(leaves, torch.as_tensor(toks), V)
     * torch.as_tensor(dY)).sum().backward()
    np.testing.assert_allclose(dA.numpy(), leaves["A"].grad.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(dB.numpy(), leaves["B"].grad.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_repeated_tokens_accumulate(backend):
    """Duplicate tokens accumulate gradient mass on their row, and every
    other row of dA is exactly 0."""
    V, d, R = 30, 4, 3
    rp, tp = _params(V, d, R, seed=5)
    toks = np.zeros((1, 7), np.int32)                # all the same token
    dY = np.ones((1, 7, d), np.float32)
    dA, _ = fe.grad_factors_mttkrp(tp, torch.as_tensor(toks), torch.as_tensor(dY), V,
                                   kappa=2, backend=backend)
    rA, _ = r_fe.grad_factors_mttkrp(rp, jnp.asarray(toks), jnp.asarray(dY), V, kappa=2)
    i1 = int(fe.split_ids(torch.as_tensor(toks), V)[0][0, 0])
    assert float(dA[i1].abs().sum()) > 0
    np.testing.assert_allclose(dA[i1].numpy(), np.asarray(rA)[i1], **GRAD_TOL)
    others = np.delete(dA.numpy(), i1, axis=0)
    assert np.array_equal(others, np.zeros_like(others))
