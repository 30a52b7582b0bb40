"""Port vs JAX package: the Mamba-2 SSD (``repro_torch.models.ssm``) on
the CPU, at ``tests/models/test_components.py``'s sizes, in float32.

``ssd_apply`` with and without a state (S a multiple of the chunk, not
one, and S < K - 1), the state it hands on and ``ssd_decode_step``, all
within 1e-5 relative; the port's decode continuing its own scan within
5e-4; the chunk-size invariance of ``test_components.py`` at its own
tolerance.  ``rel(a, b) = max|a - b| / max|b|``.  Parameters are the
reference's ``build_params`` draws (with the zero-initialized vectors
redrawn with numpy), carried by ``params_from_reference``; inputs are
drawn with numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as rssm
from repro.models.base import ModelConfig as RefConfig
from repro.models.common import build_params as ref_build_params
from repro_torch.convert import params_from_reference
from repro_torch.models import ssm
from repro_torch.models.base import ModelConfig

CFG = dict(arch="t", family="dense", num_layers=1, d_model=64, num_heads=4,
           num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128, dtype="float32",
           remat="none", attn_chunk=8)
TOL = 1e-5


def _cfgs(**kw):
    return RefConfig(**{**CFG, **kw}), ModelConfig(**{**CFG, **kw})


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _params(specs, seed=0):
    ref = ref_build_params(specs, jax.random.PRNGKey(seed), jnp.float32)
    return ref, params_from_reference(jax.tree.map(np.asarray, ref), "cpu")


def _x(shape, seed=1, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# -- SSD -----------------------------------------------------------------------

SSM = dict(family="ssm", ssm_state=8, ssm_head_dim=16, ssm_ngroups=2, ssm_chunk=4,
           conv_kernel=4)


def _ssm_setup(**kw):
    rcfg, cfg = _cfgs(**{**SSM, **kw})
    rp, p = _params(rssm.ssm_specs(rcfg))
    # nonzero A_log, D, dt_bias and norm scale: the zeros init hides them
    rng = np.random.default_rng(7)
    for name in ("A_log", "D", "dt_bias", "norm_scale", "conv_b"):
        v = (0.5 * rng.standard_normal(rp[name].shape)).astype(np.float32)
        rp[name] = jnp.asarray(v)
        p[name] = torch.as_tensor(v)
    return rcfg, cfg, rp, p


def _state_pair(rcfg, cfg, B, seed=None):
    rst = rssm.init_ssm_state(rcfg, B, jnp.float32)
    st = ssm.init_ssm_state(cfg, B, torch.float32, "cpu")
    if seed is not None:
        rng = np.random.default_rng(seed)
        h = (0.5 * rng.standard_normal(st["ssm"].shape)).astype(np.float32)
        rst["ssm"] = jnp.asarray(h)
        st["ssm"].copy_(torch.as_tensor(h))
    return rst, st


@pytest.mark.parametrize("with_state", [False, True], ids=["stateless", "state"])
@pytest.mark.parametrize("S", [2, 12, 13], ids=["S_below_K-1", "chunk_multiple", "padded"])
def test_ssd_apply_matches_reference(S, with_state):
    rcfg, cfg, rp, p = _ssm_setup()
    B = 2
    x = _x((B, S, cfg.d_model), scale=0.5)
    if not with_state:
        ry, rnew = rssm.ssd_apply(rcfg, rp, jnp.asarray(x))
        y, new = ssm.ssd_apply(cfg, p, torch.as_tensor(x))
        assert rnew is None and new is None
        assert _rel(y.numpy(), ry) <= TOL
        return
    rst, st = _state_pair(rcfg, cfg, B, seed=3)
    ssm_buf, conv_buf = st["ssm"], st["conv"]
    ry, rnew = rssm.ssd_apply(rcfg, rp, jnp.asarray(x), state=rst)
    y, new = ssm.ssd_apply(cfg, p, torch.as_tensor(x), state=st)
    assert _rel(y.numpy(), ry) <= TOL
    assert new["ssm"] is ssm_buf and new["conv"] is conv_buf      # in place
    assert new["pos"] == int(rnew["pos"]) == S
    assert _rel(new["ssm"].numpy(), rnew["ssm"]) <= TOL
    np.testing.assert_allclose(new["conv"].numpy(), np.asarray(rnew["conv"]),
                               rtol=TOL, atol=1e-7)


def test_ssd_decode_step_matches_reference():
    """Three recurrent steps after a prefill of 13 tokens, each step's output
    and state against the reference's."""
    rcfg, cfg, rp, p = _ssm_setup()
    B = 2
    x = _x((B, 16, cfg.d_model), scale=0.5)
    rst, st = _state_pair(rcfg, cfg, B)
    _, rst = rssm.ssd_apply(rcfg, rp, jnp.asarray(x[:, :13]), state=rst)
    _, st = ssm.ssd_apply(cfg, p, torch.as_tensor(x[:, :13]), state=st)
    for t in range(13, 16):
        ry, rst = rssm.ssd_decode_step(rcfg, rp, jnp.asarray(x[:, t:t + 1]), rst)
        y, st = ssm.ssd_decode_step(cfg, p, torch.as_tensor(x[:, t:t + 1]), st)
        assert _rel(y.numpy(), ry) <= TOL, t
        assert _rel(st["ssm"].numpy(), rst["ssm"]) <= TOL, t
        np.testing.assert_allclose(st["conv"].numpy(), np.asarray(rst["conv"]),
                                   rtol=TOL, atol=1e-7)


def test_ssd_decode_continues_the_scan():
    """The port's recurrent steps after a prefill give the port's own scan
    over the whole sequence (the decode-vs-forward bound, 5e-4)."""
    _, cfg, _, p = _ssm_setup()
    x = torch.as_tensor(_x((2, 16, cfg.d_model), scale=0.5))
    full, _ = ssm.ssd_apply(cfg, p, x)
    st = ssm.init_ssm_state(cfg, 2, torch.float32, "cpu")
    _, st = ssm.ssd_apply(cfg, p, x[:, :13], state=st)
    for t in range(13, 16):
        y, st = ssm.ssd_decode_step(cfg, p, x[:, t:t + 1], st)
        assert _rel(y.numpy(), full[:, t:t + 1].numpy()) < 5e-4, t


def test_ssd_state_invariance_to_chunk_size():
    """``test_components.py::test_ssd_state_invariance_to_chunk_size`` on
    the port, at its tolerance, and each chunk size against the reference."""
    rcfg, cfg, rp, p = _ssm_setup()
    x = _x((2, 24, cfg.d_model), scale=0.5)
    ys = []
    for chunk in (4, 8):
        y, _ = ssm.ssd_apply(dataclasses.replace(cfg, ssm_chunk=chunk), p,
                             torch.as_tensor(x))
        ry, _ = rssm.ssd_apply(dataclasses.replace(rcfg, ssm_chunk=chunk), rp,
                               jnp.asarray(x))
        assert _rel(y.numpy(), ry) <= TOL, chunk
        ys.append(y.numpy())
    np.testing.assert_allclose(ys[0], ys[1], rtol=2e-4, atol=2e-4)
