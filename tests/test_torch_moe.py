"""Port vs JAX package: the Mixture-of-Experts half of
``repro_torch.models.mlp`` on the CPU, at ``tests/models/test_components.py``'s
sizes, in float32.

The router's expert ids are the reference's exactly, the kept capacity
slots too, and outputs and the aux loss agree within 1e-5 (relative) on
the dense-eval (``train=False``) and the capacity dispatch
(``train=True``), the latter also at a capacity that drops tokens;
``_segment_positions`` is bitwise.  ``rel(a, b) = max|a - b| / max|b|``.
Parameters are the reference's ``build_params`` draws, carried by
``params_from_reference``; inputs are drawn with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp as rmlp
from repro.models.base import ModelConfig as RefConfig
from repro.models.common import build_params as ref_build_params
from repro_torch.convert import params_from_reference
from repro_torch.models import mlp
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


# -- MoE -----------------------------------------------------------------------

# (experts, top-k, capacity factor, batch, seq): granite's and dbrx's
# routing shapes cut down, and test_moe_drops_overflow_tokens' shape, whose
# capacity (8 per expert) serves 16 of 64 tokens.
MOE_CASES = {"top2_of_4": (4, 2, 1.25, 2, 9), "top4_of_8": (8, 4, 1.25, 2, 16),
             "drops": (2, 1, 0.25, 1, 64)}


@pytest.mark.parametrize("train", [False, True], ids=["dense_eval", "dispatch"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case, train):
    E, k, cf, B, S = MOE_CASES[case]
    rcfg, cfg = _cfgs(family="moe", num_experts=E, num_experts_per_tok=k, moe_dff=16,
                      capacity_factor=cf)
    rp, p = _params(rmlp.moe_specs(rcfg))
    assert p["router"].dtype == torch.float32
    x = _x((B, S, cfg.d_model), scale=1.0)
    ry, raux = rmlp.moe_apply(rcfg, rp, jnp.asarray(x), train=train)
    y, aux = mlp.moe_apply(cfg, p, torch.as_tensor(x), train=train)
    assert y.shape == (B, S, cfg.d_model) and aux.dtype == torch.float32 and aux.ndim == 0
    assert _rel(y.numpy(), ry) <= TOL
    assert abs(float(aux) - float(raux)) <= TOL * abs(float(raux))
    if case == "drops" and train:
        served = float((y.abs() > 0).any(-1).float().mean())
        assert served <= 0.5


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_routing_and_kept_slots_match_reference(case):
    """The same expert ids and gates from the router, and after the stable
    sort the same within-expert positions and the same kept slots."""
    E, k, cf, B, S = MOE_CASES[case]
    rcfg, cfg = _cfgs(family="moe", num_experts=E, num_experts_per_tok=k, moe_dff=16,
                      capacity_factor=cf)
    rp, p = _params(rmlp.moe_specs(rcfg))
    x = _x((B, S, cfg.d_model), scale=1.0)
    rgate, rexpert = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ rp["router"], -1), k)
    _, gate, expert, _ = mlp._route(cfg, p, torch.as_tensor(x))
    np.testing.assert_array_equal(expert.numpy(), np.asarray(rexpert))
    rg = np.asarray(rgate / rgate.sum(-1, keepdims=True))
    np.testing.assert_allclose(gate.numpy(), rg, rtol=TOL, atol=0)

    C = max(8, -(-int(cf * S * k / E) // 8) * 8)
    fe = expert.reshape(B, S * k)
    order = torch.argsort(fe, dim=1, stable=True)
    rorder = np.asarray(jnp.argsort(jnp.asarray(fe.numpy()), axis=1))
    np.testing.assert_array_equal(order.numpy(), rorder)
    se = torch.gather(fe, 1, order)
    pos = mlp._segment_positions(se)
    rpos = np.asarray(jax.vmap(rmlp._segment_positions)(jnp.asarray(se.numpy())))
    np.testing.assert_array_equal(pos.numpy(), rpos)
    slot = torch.where(pos < C, se * C + pos, E * C)
    rslot = np.where(rpos < C, np.asarray(se) * C + rpos, E * C)
    np.testing.assert_array_equal(slot.numpy(), rslot)
    assert (case == "drops") == bool((slot == E * C).any())


@pytest.mark.parametrize("seed", range(3))
def test_segment_positions_bitwise(seed):
    ids = np.sort(np.random.default_rng(seed).integers(0, 5, 40))
    want = np.asarray(rmlp._segment_positions(jnp.asarray(ids)))
    np.testing.assert_array_equal(mlp._segment_positions(torch.as_tensor(ids)).numpy(), want)
    rows = np.sort(np.random.default_rng(seed + 10).integers(0, 3, (4, 12)), axis=1)
    want = np.asarray(jax.vmap(rmlp._segment_positions)(jnp.asarray(rows)))
    np.testing.assert_array_equal(mlp._segment_positions(torch.as_tensor(rows)).numpy(), want)
