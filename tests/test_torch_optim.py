"""Port vs JAX package: the optimizer substrate (``repro_torch.optim``) on
the CPU, through the cases of ``tests/substrate/test_optim.py``.

AdamW runs the same steps on the same quadratic in both packages
(parameters within 1e-6 relative), the schedule agrees at every step
(1e-7), clipping and ``global_norm`` to 1e-6, and weight decay skips
1-D leaves as the reference's does.  ``quantize`` is bitwise the
reference's; 50 error-feedback steps agree to 1e-6.  An AdamW state and
parameters handed over midway through ``repro_torch.convert`` continue
the reference's run.  ``cross_pod_mean`` across two ranks is in
``tests/test_torch_service_mesh.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ro
from repro_torch import optim
from repro_torch.convert import adamw_state_from_reference, params_from_reference
from repro_torch.launch import make_mesh

TARGET = {"w": np.asarray([1.0, -2.0, 3.0], np.float32),
          "m": np.arange(6, dtype=np.float32).reshape(2, 3) / 4.0 - 0.5}
CONFIGS = {
    "constant": dict(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=300,
                     schedule="constant", grad_clip=0.0),
    "cosine_clip": dict(lr=0.05, weight_decay=0.1, warmup_steps=5, total_steps=20,
                        grad_clip=1.0),
    "linear": dict(lr=0.02, weight_decay=0.05, warmup_steps=3, total_steps=15,
                   schedule="linear", grad_clip=2.0),
}


def _start():
    return {"w": np.zeros(3, np.float32), "m": np.ones((2, 3), np.float32)}


def _ref_steps(cfg, params, state, n):
    for _ in range(n):
        g = jax.grad(lambda p: sum(jnp.sum((p[k] - TARGET[k]) ** 2) for k in p))(params)
        params, state, m = ro.apply_updates(cfg, params, g, state)
    return params, state, m


def _port_steps(cfg, params, state, n):
    for _ in range(n):
        g = {k: 2.0 * (params[k] - torch.as_tensor(TARGET[k])) for k in params}
        params, state, m = optim.apply_updates(cfg, params, g, state)
    return params, state, m


def _close_tree(got, ref, tol):
    for k in ref:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].numpy(), r, rtol=tol, atol=tol * np.abs(r).max())


@pytest.mark.parametrize("name", CONFIGS)
def test_adamw_20_steps_match_reference(name):
    kw = CONFIGS[name]
    rp = {k: jnp.asarray(v) for k, v in _start().items()}
    rp, rs, rm = _ref_steps(ro.AdamWConfig(**kw), rp, ro.init_state(rp), 20)
    tp = {k: torch.as_tensor(v) for k, v in _start().items()}
    tp, ts, tm = _port_steps(optim.AdamWConfig(**kw), tp, optim.init_state(tp), 20)
    _close_tree(tp, rp, 1e-6)
    _close_tree(ts["mu"], rs["mu"], 1e-6)
    _close_tree(ts["nu"], rs["nu"], 1e-6)
    assert int(ts["step"]) == int(rs["step"]) == 20 and ts["step"].dtype == torch.int32
    np.testing.assert_allclose(tm["grad_norm"].item(), float(rm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tm["lr"].item(), float(rm["lr"]), rtol=1e-6)


def test_adamw_converges_quadratic():
    tp = {"w": torch.zeros(3)}
    cfg = optim.AdamWConfig(**CONFIGS["constant"])
    state = optim.init_state(tp)
    for _ in range(300):
        g = {"w": 2.0 * (tp["w"] - torch.as_tensor(TARGET["w"]))}
        tp, state, _ = optim.apply_updates(cfg, tp, g, state)
    np.testing.assert_allclose(tp["w"].numpy(), TARGET["w"], atol=1e-2)


def test_state_handed_over_from_the_reference_continues_its_run():
    cfg = CONFIGS["cosine_clip"]
    rp = {k: jnp.asarray(v) for k, v in _start().items()}
    rp, rs, _ = _ref_steps(ro.AdamWConfig(**cfg), rp, ro.init_state(rp), 10)
    host = jax.tree.map(np.asarray, (rp, rs))
    tp = params_from_reference(host[0], device="cpu")
    ts = adamw_state_from_reference(host[1], device="cpu")
    assert int(ts["step"]) == 10 and ts["step"].dtype == torch.int32
    rp, rs, _ = _ref_steps(ro.AdamWConfig(**cfg), rp, rs, 10)
    tp, ts, _ = _port_steps(optim.AdamWConfig(**cfg), tp, ts, 10)
    _close_tree(tp, rp, 1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_every_step_matches_reference(schedule):
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1,
               schedule=schedule)
    r, p = ro.AdamWConfig(**cfg), optim.AdamWConfig(**cfg)
    for s in range(0, 111):
        np.testing.assert_allclose(float(optim.lr_at(p, s)), float(ro.lr_at(r, s)),
                                   rtol=0, atol=1e-7)
    lrs = [float(optim.lr_at(p, s)) for s in [0, 5, 10, 55, 100]]
    assert lrs[0] < lrs[1] < lrs[2] == pytest.approx(1e-3)


def test_grad_clip_and_global_norm_match_reference():
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((4, 4)).astype(np.float32) * 100,
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    rtree = jax.tree.map(jnp.asarray, tree)
    ttree = params_from_reference(tree, device="cpu")
    np.testing.assert_allclose(optim.global_norm(ttree).item(),
                               float(ro.global_norm(rtree)), rtol=1e-6)
    params = {"a": np.ones((4, 4), np.float32), "b": {"c": np.ones(5, np.float32)}}
    rp = jax.tree.map(jnp.asarray, params)
    tp = params_from_reference(params, device="cpu")
    rp2, _, rm = ro.apply_updates(ro.AdamWConfig(grad_clip=1.0), rp, rtree,
                                  ro.init_state(rp))
    tp2, _, tm = optim.apply_updates(optim.AdamWConfig(grad_clip=1.0), tp, ttree,
                                     optim.init_state(tp))
    np.testing.assert_allclose(tm["grad_norm"].item(), float(rm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tp2["a"].numpy(), np.asarray(rp2["a"]), rtol=1e-6)
    np.testing.assert_allclose(tp2["b"]["c"].numpy(), np.asarray(rp2["b"]["c"]), rtol=1e-6)


def test_weight_decay_skips_1d():
    kw = dict(lr=1.0, weight_decay=0.5, warmup_steps=0, schedule="constant",
              grad_clip=0.0)
    params = {"w": np.ones((2, 2), np.float32), "b": np.ones((2,), np.float32)}
    rp = jax.tree.map(jnp.asarray, params)
    rp2, _, _ = ro.apply_updates(ro.AdamWConfig(**kw), rp, jax.tree.map(jnp.zeros_like, rp),
                                 ro.init_state(rp))
    tp = params_from_reference(params, device="cpu")
    tp2, _, _ = optim.apply_updates(optim.AdamWConfig(**kw), tp,
                                    {k: torch.zeros_like(v) for k, v in tp.items()},
                                    optim.init_state(tp))
    assert float(tp2["w"][0, 0]) < 1.0                 # decayed
    assert float(tp2["b"][0]) == 1.0                   # not decayed
    np.testing.assert_allclose(tp2["w"].numpy(), np.asarray(rp2["w"]), rtol=1e-6)
    assert np.array_equal(tp2["b"].numpy(), np.asarray(rp2["b"]))


@pytest.mark.parametrize("seed,shape,axis", [(0, (128,), None), (1, (64, 9), None),
                                             (2, (64, 9), 1), (3, (5, 7, 3), 0)])
def test_quantize_is_bitwise_the_reference(seed, shape, axis):
    x = (np.random.default_rng(seed).standard_normal(shape) * 10).astype(np.float32)
    rq, rs = ro.quantize(jnp.asarray(x), axis=axis)
    q, s = optim.quantize(torch.as_tensor(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(s.numpy(), np.asarray(rs))
    assert np.array_equal(optim.dequantize(q, s).numpy(),
                          np.asarray(ro.dequantize(rq, rs)))
    rel = float((optim.dequantize(q, s) - torch.as_tensor(x)).abs().max()
                / np.abs(x).max())
    assert rel < 0.02


def test_int8_error_feedback_50_steps_match_reference():
    rng = np.random.default_rng(0)
    g_true = rng.standard_normal((64,)).astype(np.float32)
    err, rerr = torch.zeros(64), jnp.zeros((64,))
    acc, racc = np.zeros(64), np.zeros(64)
    for _ in range(50):
        g = g_true + 0.01 * rng.standard_normal(64).astype(np.float32)
        rq, rs = ro.quantize(jnp.asarray(g) + rerr)
        rdeq = ro.dequantize(rq, rs)
        rerr = (jnp.asarray(g) + rerr) - rdeq
        q, s = optim.quantize(torch.as_tensor(g) + err)
        deq = optim.dequantize(q, s)
        err = (torch.as_tensor(g) + err) - deq
        acc += deq.numpy()
        racc += np.asarray(rdeq)
    np.testing.assert_allclose(acc, racc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(err.numpy(), np.asarray(rerr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(acc / 50, g_true, atol=0.05)


def test_cross_pod_mean_without_the_axis_returns_its_inputs():
    g = {"a": torch.randn(4, 3)}
    e = {"a": torch.zeros(4, 3)}
    got, err = optim.cross_pod_mean(g, e, make_mesh((1,), ("sm",), device="cpu"))
    assert got is g and err is e
    got, err = optim.cross_pod_mean(g, e, make_mesh((1,), ("pod",), device="cpu"))
    q, s = optim.quantize(g["a"])
    assert torch.equal(got["a"], optim.dequantize(q, s))
    assert torch.equal(err["a"], g["a"] - optim.dequantize(q, s))
