"""Port vs JAX package: attention (``repro_torch.models.attention``) on the
CPU, at ``tests/models/test_components.py``'s sizes.

The chunked online softmax on the reference test's grid of (causal,
window) x S against the reference's ``_chunked_attention`` at its own
``rtol=2e-4, atol=2e-4``; a window-sized ring buffer decoding as a full
buffer does; ``quantize_kv``'s scales and int8 values; the single-pass
decode attention and the cross-attention branch.  Parameters are the
reference's ``build_params`` draws, carried by ``params_from_reference``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as rattn
from repro.models.base import ModelConfig as RefConfig
from repro.models.common import build_params as ref_build_params
from repro_torch.convert import params_from_reference
from repro_torch.models import attention as attn
from repro_torch.models.base import ModelConfig

CFG = dict(arch="t", family="dense", num_layers=1, d_model=64, num_heads=4,
           num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128, dtype="float32",
           remat="none", attn_chunk=8)


def _cfgs(**kw):
    return RefConfig(**{**CFG, **kw}), ModelConfig(**{**CFG, **kw})


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _params(rcfg, seed=0):
    ref = ref_build_params(rattn.attn_specs(rcfg), jax.random.PRNGKey(seed), jnp.float32)
    return ref, params_from_reference(jax.tree.map(np.asarray, ref), "cpu")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
@pytest.mark.parametrize("S", [7, 16, 33])
def test_chunked_attention_matches_reference(causal, window, S):
    rng = np.random.default_rng(0)
    B, H, KH, hd = 2, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    kw = dict(num_kv=KH, q0=0, causal=causal, window=window, chunk=8)
    ref = np.asarray(rattn._chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), **kw))
    got = attn._chunked_attention(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), **kw)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_ring_buffer_decode_equals_full_cache():
    """Sliding-window decode with a window-sized ring buffer equals decode
    with a full-length buffer, and each step's output is the reference's."""
    rcfg, cfg = _cfgs(attn_window=6)
    rp, p = _params(rcfg)
    B, T = 2, 15
    xs = 0.5 * np.random.default_rng(1).standard_normal((B, T, cfg.d_model)).astype(np.float32)
    full = attn.init_attn_cache(cfg, B, T, torch.float32, device="cpu")
    ring = attn.init_attn_cache(cfg, B, cfg.attn_window, torch.float32, device="cpu")
    rring = rattn.init_attn_cache(rcfg, B, rcfg.attn_window, jnp.float32)
    outs_f, outs_r, outs_ref = [], [], []
    for t in range(T):
        x = torch.as_tensor(xs[:, t:t + 1])
        of, full = attn.attention(cfg, p, x, cache=full, window=cfg.attn_window)
        orr, ring = attn.attention(cfg, p, x, cache=ring, window=cfg.attn_window)
        oref, rring = rattn.attention(rcfg, rp, jnp.asarray(xs[:, t:t + 1]), cache=rring,
                                      window=rcfg.attn_window)
        outs_f.append(of)
        outs_r.append(orr)
        outs_ref.append(np.asarray(oref))
    assert full["pos"] == ring["pos"] == T
    np.testing.assert_allclose(torch.cat(outs_f, 1).numpy(), torch.cat(outs_r, 1).numpy(),
                               rtol=1e-4, atol=1e-5)
    assert _rel(torch.cat(outs_r, 1).numpy(), np.concatenate(outs_ref, 1)) <= 1e-5


def test_quantize_kv_matches_reference():
    x = 3.0 * np.random.default_rng(0).standard_normal((2, 5, 3, 16)).astype(np.float32)
    rq, rs = rattn.quantize_kv(jnp.asarray(x))
    q, s = attn.quantize_kv(torch.as_tensor(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-7, atol=0)
    # A quotient on a rounding tie may round the other way: at most one
    # step, and rarely.
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(rq).astype(np.int32))
    ties = int((diff > 0).sum())
    assert diff.max() <= 1 and ties <= 2, (diff.max(), ties)
    deq = q.float() * s
    assert float((deq - torch.as_tensor(x)).abs().max()) / float(np.abs(x).max()) < 0.02


@pytest.mark.parametrize("window,bf16", [(0, False), (4, False), (0, True)],
                         ids=["causal", "window", "bf16_dot"])
def test_decode_attention_matches_reference(window, bf16):
    rcfg, cfg = _cfgs(attn_bf16_dot=bf16)
    rng = np.random.default_rng(2)
    B, Sq, S_max, pos = 2, 3, 12, 5
    q = rng.standard_normal((B, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((B, S_max, 2, 16)).astype(np.float32)
    v = rng.standard_normal((B, S_max, 2, 16)).astype(np.float32)
    ref = rattn._decode_attention(rcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos, jnp.int32), Sq, causal=True,
                                  window=window)
    got = attn._decode_attention(cfg, torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), pos, Sq, causal=True, window=window)
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-5


def test_cross_attention_matches_reference():
    """Against a precomputed encoder KV (a cache without ``pos``) and
    against a fresh context ``xkv``."""
    rcfg, cfg = _cfgs()
    rp, p = _params(rcfg, seed=3)
    rng = np.random.default_rng(4)
    x = 0.5 * rng.standard_normal((2, 5, 64)).astype(np.float32)
    ctx = 0.5 * rng.standard_normal((2, 9, 64)).astype(np.float32)
    kv = {n: rng.standard_normal((2, 9, 2, 16)).astype(np.float32) for n in ("k", "v")}
    ref, _ = rattn.attention(rcfg, rp, jnp.asarray(x),
                             cache={n: jnp.asarray(a) for n, a in kv.items()})
    got, cache = attn.attention(cfg, p, torch.as_tensor(x),
                                cache={n: torch.as_tensor(a) for n, a in kv.items()})
    assert cache is None and _rel(got.numpy(), np.asarray(ref)) <= 1e-5
    ref, _ = rattn.attention(rcfg, rp, jnp.asarray(x), xkv=jnp.asarray(ctx))
    got, _ = attn.attention(cfg, p, torch.as_tensor(x), xkv=torch.as_tensor(ctx))
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-5


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
def test_prefill_then_decode_cache_matches_reference(quant):
    """A prefill stores its keys and values (int8 with scales) where the
    reference's does, and a decode step after it gives the reference's
    output; the port's buffers are written in place."""
    rcfg, cfg = _cfgs(qkv_bias=True)
    rp, p = _params(rcfg, seed=5)
    rng = np.random.default_rng(6)
    x = 0.5 * rng.standard_normal((2, 7, 64)).astype(np.float32)
    x1 = 0.5 * rng.standard_normal((2, 1, 64)).astype(np.float32)
    shape = (2, 10, 2, 16)
    rcache = {"k": jnp.zeros(shape, jnp.int8 if quant else jnp.float32),
              "v": jnp.zeros(shape, jnp.int8 if quant else jnp.float32),
              "pos": jnp.asarray(0, jnp.int32)}
    cache = {"k": torch.zeros(shape, dtype=torch.int8 if quant else torch.float32),
             "v": torch.zeros(shape, dtype=torch.int8 if quant else torch.float32),
             "pos": 0}
    if quant:
        for n in ("k_scale", "v_scale"):
            rcache[n] = jnp.zeros(shape[:3] + (1,), jnp.float32)
            cache[n] = torch.zeros(shape[:3] + (1,))
    buf = cache["k"]
    ref, rcache = rattn.attention(rcfg, rp, jnp.asarray(x), cache=rcache)
    got, cache = attn.attention(cfg, p, torch.as_tensor(x), cache=cache)
    assert cache["k"] is buf and cache["pos"] == int(rcache["pos"]) == 7
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-5
    for n in cache:
        if n != "pos":
            diff = np.abs(cache[n].numpy().astype(np.float64)
                          - np.asarray(rcache[n]).astype(np.float64))
            assert diff.max() <= (1 if n in ("k", "v") and quant else 1e-5), n
    ref, rcache = rattn.attention(rcfg, rp, jnp.asarray(x1), cache=rcache)
    got, cache = attn.attention(cfg, p, torch.as_tensor(x1), cache=cache)
    assert cache["pos"] == 8 and _rel(got.numpy(), np.asarray(ref)) <= 1e-5
