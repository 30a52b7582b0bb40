"""Port vs JAX package: the shared model machinery
(``repro_torch.models.common``) on the CPU.

Norms, RoPE and the cross-entropy run on the same numpy inputs in both
packages and agree to 1e-6.  The parameter specs, their stacking, logical
axes and abstract shapes are equal to the reference's; ``build_params``
keeps the reference's shapes, dtypes, constant initialisers and scales
(its draws come from a ``torch.Generator``, not JAX's PRNG).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as rc
from repro_torch.models import common as c

TOL = dict(rtol=1e-6, atol=1e-6)


def _specs(pc):
    """A small tree of both packages' ``PSpec`` (``pc`` is the module)."""
    return {"embed": pc.PSpec((11, 8), ("vocab", "fsdp"), "embed", scale=0.5),
            "layer": {"w": pc.PSpec((8, 6), ("fsdp", "tensor")),
                      "norm": pc.norm_specs("layernorm", 8)},
            "final": pc.norm_specs("rmsnorm", 8)}


def _fields(tree):
    if isinstance(tree, dict):
        return {k: _fields(v) for k, v in tree.items()}
    return (tuple(tree.shape), tuple(tree.axes), tree.init, tree.scale)


def _x(seed, shape=(2, 5, 8)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    x = _x(0)
    p = {"scale": _x(1, (8,)), "bias": _x(2, (8,))}
    ref = rc.apply_norm(kind, jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    got = c.apply_norm(kind, torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("cos_rank", [2, 3])
def test_rope_matches_reference(cos_rank):
    B, S, H, hd = 2, 6, 3, 8
    pos = np.arange(S)[None].repeat(B, 0) + np.arange(B)[:, None]
    if cos_rank == 2:
        pos = pos[0]
    rcos, rsin = rc.rope_freqs(hd, 10_000.0, jnp.asarray(pos))
    cos, sin = c.rope_freqs(hd, 10_000.0, torch.as_tensor(pos))
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), **TOL)
    x = _x(3, (B, S, H, hd))
    ref = rc.apply_rope(jnp.asarray(x), rcos, rsin)
    got = c.apply_rope(torch.as_tensor(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("z_loss,masked", [(1e-4, False), (0.0, False), (1e-4, True)])
def test_cross_entropy_matches_reference(z_loss, masked):
    logits = 3.0 * _x(4, (2, 5, 17))
    labels = np.random.default_rng(5).integers(0, 17, (2, 5))
    labels[0, 1] = labels[1, 3] = -1                     # ignored positions
    mask = (np.random.default_rng(6).uniform(size=(2, 5)) > 0.3) if masked else None
    ref = rc.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   z_loss=z_loss,
                                   mask=None if mask is None else jnp.asarray(mask))
    got = c.softmax_cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                                  z_loss=z_loss,
                                  mask=None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(got.item(), float(ref), **TOL)


@pytest.mark.parametrize("v", [1, 255, 256, 151_936])
def test_pad_vocab_matches_reference(v):
    assert c.pad_vocab(v) == rc.pad_vocab(v)
    assert c.pad_vocab(151_936) == 152_064


def test_specs_stacking_and_axes_match_reference():
    ours, ref = _specs(c), _specs(rc)
    assert _fields(ours) == _fields(ref)
    assert _fields(c.stack_specs(ours, 4)) == _fields(rc.stack_specs(ref, 4))
    assert c.logical_axes(ours) == rc.logical_axes(ref)
    with pytest.raises(ValueError):
        c.PSpec((3, 4), ("vocab",))


def test_abstract_params_match_reference():
    got = c.abstract_params(c.stack_specs(_specs(c), 2))
    ref = rc.abstract_params(rc.stack_specs(_specs(rc), 2))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat:
        t = got
        for k in path:
            t = t[k.key]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(leaf.shape)
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)


def test_build_params_keeps_the_reference_initialisers():
    specs = c.stack_specs(_specs(c), 2)
    ref = rc.build_params(rc.stack_specs(_specs(rc), 2), jax.random.PRNGKey(0),
                          jnp.float32)
    got = c.build_params(specs, torch.Generator().manual_seed(0), torch.float32,
                         device="cpu")
    again = c.build_params(specs, torch.Generator().manual_seed(0), torch.float32,
                           device="cpu")
    for name in ("norm", "final"):
        part = got["layer"]["norm"] if name == "norm" else got["final"]
        rpart = ref["layer"]["norm"] if name == "norm" else ref["final"]
        for k in part:
            assert np.array_equal(part[k].numpy(), np.asarray(rpart[k]))
    assert got["embed"].shape == ref["embed"].shape == (2, 11, 8)
    assert torch.equal(got["layer"]["w"], again["layer"]["w"])
    # fan_in of a stacked spec leaves the 'layers' dim out: std 1/sqrt(8)
    assert abs(float(got["layer"]["w"].std()) - 8 ** -0.5) < 0.12
    bf = c.build_params(_specs(c), torch.Generator().manual_seed(1), device="cpu")
    assert bf["embed"].dtype == torch.bfloat16


def test_params_from_reference_keeps_dtypes():
    """The reference's default parameter dtype is bfloat16: its trees reach
    the port bitwise, float32 leaves too."""
    from repro_torch.convert import params_from_reference

    ref = rc.build_params(_specs(rc), jax.random.PRNGKey(3))
    host = jax.tree.map(np.asarray, ref)
    got = params_from_reference(host, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    assert np.array_equal(got["embed"].float().numpy(),
                          np.asarray(ref["embed"], np.float32))
    f32 = params_from_reference({"a": {"b": np.arange(3, dtype=np.float32)}}, device="cpu")
    assert f32["a"]["b"].dtype == torch.float32 and f32["a"]["b"].tolist() == [0, 1, 2]
