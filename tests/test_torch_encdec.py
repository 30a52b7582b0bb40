"""Port vs JAX package: the encoder-decoder (``repro_torch.models.encdec``,
Whisper's backbone) on the CPU, in float32 at reduced size.

Reduced whisper-large-v3 (2 + 2 layers, 24 encoder frames): the encoder's
output, ``forward`` logits and the loss; a prefill's logits, its
per-layer cross-attention KV (``cross_k`` / ``cross_v``) and
self-attention cache; four decode steps teacher-forced with the
reference's greedy tokens (logits and argmax), all within 1e-4 relative.
The port decodes as its own ``forward`` within the reference's 5e-4, and
its int8 self-attention cache within 0.05 of the native one.  The
launcher's ``generate`` serves it with encoder frames.
``rel(a, b) = max|a - b| / max|b|``.  The reference runs once, jitted, in
a module-scoped fixture; parameters are its ``model.init`` draws, carried
by ``params_from_reference``; inputs are drawn with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro_torch import configs
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.launch import serve
from repro_torch.models import EncDec, get_model

ARCH = "whisper-large-v3"
B, S, GEN = 2, 9, 4
TOL = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "encoder_embeds": (0.1 * rng.standard_normal(
               (B, cfg.enc_seq, cfg.d_model))).astype(np.float32)}
    out["labels"][1, 2] = -1                        # an ignored position
    return out


@pytest.fixture(scope="module")
def ref():
    """The reference's encoder, forward, loss, prefill and GEN greedy
    decode steps, computed once."""
    cfg = rconfigs.reduce_config(rconfigs.get_config(ARCH))
    model = rmodels.get_model(cfg)
    params = model.init(jax.random.PRNGKey(30))
    x = _inputs(cfg, 30)
    toks, enc = jnp.asarray(x["tokens"]), jnp.asarray(x["encoder_embeds"])
    out = {"params": jax.tree.map(np.asarray, params), "inputs": x}
    out["encode"] = np.asarray(jax.jit(model.encode)(params, enc))
    out["forward"] = np.asarray(jax.jit(model.forward)(params, toks, enc)[0])
    out["loss"] = float(jax.jit(model.loss)(
        params, {k: jnp.asarray(v) for k, v in x.items()})[0])
    cache = model.init_cache(B, S + GEN, dtype=jnp.float32)
    prefill = jax.jit(lambda p, t, c, e: model.prefill(p, t, c, encoder_embeds=e))
    logits, cache = prefill(params, toks, cache, enc)
    out["prefill"] = np.asarray(logits)
    out["prefill_cache"] = jax.tree.map(np.asarray, cache)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    out["greedy"], out["decode"] = [np.asarray(tok)], []
    decode = jax.jit(model.decode_step)
    for _ in range(GEN):
        logits, cache = decode(params, tok[:, None], cache)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        out["decode"].append(np.asarray(logits))
        out["greedy"].append(np.asarray(tok))
    return out


def _port(r):
    cfg = configs.reduce_config(configs.get_config(ARCH))
    model = get_model(cfg)
    assert isinstance(model, EncDec)
    return model, params_from_reference(r["params"], "cpu")


def _x(r):
    return {k: torch.as_tensor(v) for k, v in r["inputs"].items()}


def test_encode_forward_and_loss_match_reference(ref):
    model, params = _port(ref)
    x = _x(ref)
    assert _rel(model.encode(params, x["encoder_embeds"]).numpy(), ref["encode"]) <= TOL
    full, aux = model.forward(params, x["tokens"], x["encoder_embeds"])
    assert full.shape == (B, S, model.cfg.padded_vocab) and float(aux) == 0.0
    assert _rel(full.numpy(), ref["forward"]) <= TOL
    loss, _ = model.loss(params, x)
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])


def test_prefill_cross_kv_and_cache_match_reference(ref):
    model, params = _port(ref)
    x = _x(ref)
    cache = model.init_cache(B, S + GEN, dtype=torch.float32, device="cpu")
    cross_k = cache["cross_k"]
    logits, cache = model.prefill(params, x["tokens"], cache,
                                  encoder_embeds=x["encoder_embeds"])
    assert _rel(logits.numpy(), ref["prefill"]) <= TOL
    assert cache["cross_k"] is cross_k                     # written in place
    assert cache["pos"] == int(ref["prefill_cache"]["pos"]) == S
    want = cache_from_reference(ref["prefill_cache"], "cpu")
    for got, w in ((cache["cross_k"], want["cross_k"]), (cache["cross_v"], want["cross_v"]),
                   (cache["self"]["k"], want["self"]["k"]),
                   (cache["self"]["v"], want["self"]["v"])):
        assert got.shape == w.shape and got.dtype == w.dtype
        assert _rel(got.numpy(), w.numpy()) <= TOL


def test_decode_steps_match_reference(ref):
    model, params = _port(ref)
    cache = cache_from_reference(ref["prefill_cache"], "cpu")
    for t in range(GEN):
        tok = torch.tensor(ref["greedy"][t])[:, None]
        logits, cache = model.decode_step(params, tok, cache)
        assert _rel(logits.numpy(), ref["decode"][t]) <= TOL, t
        np.testing.assert_array_equal(torch.argmax(logits[:, -1], -1).numpy(),
                                      ref["greedy"][t + 1])
    assert cache["pos"] == S + GEN


@pytest.mark.parametrize("quant", [False, True], ids=["native", "int8"])
def test_decode_matches_forward(quant):
    """Each of the last GEN tokens decoded after a prefill of the others
    against ``forward`` on the whole sequence: the reference's 5e-4 with
    the native cache; with the int8 cache, 0.05 of the native decode and
    its argmax."""
    cfg = configs.reduce_config(configs.get_config(ARCH))
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    x = {k: torch.as_tensor(v) for k, v in _inputs(cfg, 1).items()}
    toks, enc = x["tokens"], x["encoder_embeds"]
    full, _ = model.forward(params, toks, enc)
    caches = {q: model.init_cache(B, S, dtype=torch.float32, quant_kv=q, device="cpu")
              for q in (False, quant)}
    for c in caches.values():
        model.prefill(params, toks[:, :S - GEN], c, encoder_embeds=enc)
    for t in range(S - GEN, S):
        native, _ = model.decode_step(params, toks[:, t:t + 1], caches[False])
        assert _rel(native.numpy(), full[:, t:t + 1].numpy()) < 5e-4, t
        if quant:
            q, _ = model.decode_step(params, toks[:, t:t + 1], caches[True])
            assert caches[True]["self"]["k"].dtype == torch.int8
            assert _rel(q.numpy(), native.numpy()) < 0.05, t
            assert torch.equal(torch.argmax(q, -1), torch.argmax(native, -1)), t


def test_generate_serves_encoder_frames(ref):
    """``generate`` with ``encoder_embeds`` gives the reference's greedy
    tokens."""
    model, params = _port(ref)
    x = _x(ref)
    out = serve.generate(model, params, x["tokens"], GEN + 1,
                         encoder_embeds=x["encoder_embeds"])
    np.testing.assert_array_equal(out["tokens"], np.stack(ref["greedy"], axis=1))
