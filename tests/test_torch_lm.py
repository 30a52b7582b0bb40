"""Port vs JAX package: the decoder-only LM (``repro_torch.models.lm``) on
the CPU, in float32 at reduced sizes.

Reduced qwen1.5-4b carries the full parity: ``forward`` logits, a
prefill's logits and cache, four decode steps teacher-forced with the
reference's greedy tokens (logits and argmax), the loss with and without
``loss_chunk``, and the CPD-factorized embedding (``cpd_embed_rank``).
qwen1.5-32b, minitron-4b (ReLU^2), phi4-mini-3.8b (GQA) and internvl2-1b
(VLM prefix embeddings) hold ``forward`` to the reference; every
dense-segment arch decodes as its own ``forward`` within the reference's
5e-4; the int8 cache equals the reference's and stays within
``test_arch_smoke.py``'s bound of the native one.  The other families
are held in ``test_torch_lm_families.py`` and ``test_torch_encdec.py``.
``rel(a, b) = max|a - b| / max|b|``, the reference's own measure.  The
reference runs once, in a module-scoped fixture; parameters are its
``model.init`` draws, carried by ``params_from_reference``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro_torch import configs
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.models import get_model

B, S, GEN = 2, 17, 4
OTHERS = ["qwen1.5-32b", "minitron-4b", "phi4-mini-3.8b", "internvl2-1b"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    out["labels"][0, 3] = -1                        # an ignored position
    if cfg.num_prefix_tokens:
        out["prefix_embeds"] = 0.02 * rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


def _reference_serve(cfg, seed, steps=GEN):
    """The reference's forward, prefill and ``steps`` greedy decode steps
    (each function jitted once: its layer scan then compiles once)."""
    model = rmodels.get_model(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    x = _inputs(cfg, seed)
    toks = jnp.asarray(x["tokens"])
    out = {"params": _np_tree(params), "inputs": x}
    out["forward"] = np.asarray(jax.jit(model.forward)(params, toks)[0])
    cache = model.init_cache(B, S + GEN, dtype=jnp.float32)
    logits, cache = jax.jit(model.prefill)(params, toks, cache)
    out["prefill"], out["prefill_cache"] = np.asarray(logits), _np_tree(cache)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    out["greedy"], out["decode"] = [np.asarray(tok)], []
    decode = jax.jit(model.decode_step)
    for _ in range(steps):
        logits, cache = decode(params, tok[:, None], cache)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        out["decode"].append(np.asarray(logits))
        out["greedy"].append(np.asarray(tok))
    return out


@pytest.fixture(scope="module")
def ref():
    """Every reference output this file compares with, computed once."""
    cfg = rconfigs.reduce_config(rconfigs.get_config("qwen1.5-4b"))
    out = {"qwen": _reference_serve(cfg, 0),
           "cpd": _reference_serve(dataclasses.replace(cfg, cpd_embed_rank=8), 1, steps=1)}
    p, x = out["qwen"]["params"], out["qwen"]["inputs"]
    batch = {k: jnp.asarray(v) for k, v in x.items()}
    for chunk in (0, 8):
        model = rmodels.get_model(dataclasses.replace(cfg, loss_chunk=chunk))
        loss, metrics = jax.jit(model.loss)(p, batch)
        out[f"loss{chunk}"] = (float(loss), float(metrics["ce"]))
    # The int8 cache on reduced qwen1.5-32b: a prefill, then one decode step.
    rcfg = rconfigs.reduce_config(rconfigs.get_config("qwen1.5-32b"))
    model = rmodels.get_model(rcfg)
    params = model.init(jax.random.PRNGKey(2))
    toks = jnp.asarray(_inputs(rcfg, 3)["tokens"])
    cache = model.init_cache(B, S + GEN, dtype=jnp.float32, quant_kv=True)
    _, cache = jax.jit(model.prefill)(params, toks[:, :-1], cache)
    logits, cache = jax.jit(model.decode_step)(params, toks[:, -1:], cache)
    out["int8"] = {"params": _np_tree(params), "tokens": np.asarray(toks),
                   "decode": np.asarray(logits), "cache": _np_tree(cache)}
    for i, arch in enumerate(OTHERS):
        rcfg = rconfigs.reduce_config(rconfigs.get_config(arch))
        model = rmodels.get_model(rcfg)
        params = model.init(jax.random.PRNGKey(10 + i))
        x = _inputs(rcfg, 10 + i)
        kw = {"prefix_embeds": jnp.asarray(x["prefix_embeds"])} if "prefix_embeds" in x else {}
        out[arch] = {"params": _np_tree(params), "inputs": x,
                     "forward": np.asarray(jax.jit(model.forward)(
                         params, jnp.asarray(x["tokens"]), **kw)[0])}
    return out


def _port(arch, r, **replace):
    cfg = configs.reduce_config(configs.get_config(arch))
    if replace:
        cfg = dataclasses.replace(cfg, **replace)
    return get_model(cfg), params_from_reference(r["params"], "cpu")


def _decode_vs_forward(model, params, toks, prefix=None) -> tuple[float, tuple]:
    """The port's decode of the last token after a prefill of the others,
    against its own ``forward`` on the whole sequence."""
    full, _ = model.forward(params, toks, prefix_embeds=prefix)
    cache = model.init_cache(B, S + GEN, dtype=torch.float32, device="cpu")
    _, cache = model.prefill(params, toks[:, :-1], cache, prefix_embeds=prefix)
    dec, cache = model.decode_step(params, toks[:, -1:], cache)
    return _rel(dec.numpy(), full[:, -1:].numpy()), tuple(dec.shape)


def test_forward_prefill_and_cache_match_reference(ref):
    r = ref["qwen"]
    model, params = _port("qwen1.5-4b", r)
    toks = torch.as_tensor(r["inputs"]["tokens"])
    full, aux = model.forward(params, toks)
    assert full.shape == (B, S, model.cfg.padded_vocab) and float(aux) == 0.0
    assert _rel(full.numpy(), r["forward"]) <= 1e-4
    cache = model.init_cache(B, S + GEN, dtype=torch.float32, device="cpu")
    k_buf = cache["seg0_layers"]["k"]
    logits, cache = model.prefill(params, toks, cache)
    assert _rel(logits.numpy(), r["prefill"]) <= 1e-4
    assert cache["pos"] == int(r["prefill_cache"]["pos"]) == S
    assert cache["seg0_layers"]["k"] is k_buf           # written in place
    want = cache_from_reference(r["prefill_cache"], "cpu")
    for name in ("k", "v"):
        got = cache["seg0_layers"][name]
        assert got.shape == want["seg0_layers"][name].shape
        assert _rel(got.numpy(), want["seg0_layers"][name].numpy()) <= 1e-5, name


def test_decode_steps_match_reference(ref):
    """Four decode steps fed the reference's greedy tokens: logits within
    1e-4 and the port's argmax equal to the reference's at every step."""
    r = ref["qwen"]
    model, params = _port("qwen1.5-4b", r)
    cache = cache_from_reference(r["prefill_cache"], "cpu")
    for t in range(GEN):
        tok = torch.tensor(r["greedy"][t])[:, None]
        logits, cache = model.decode_step(params, tok, cache)
        assert _rel(logits.numpy(), r["decode"][t]) <= 1e-4, t
        np.testing.assert_array_equal(torch.argmax(logits[:, -1], -1).numpy(),
                                      r["greedy"][t + 1])
    assert cache["pos"] == S + GEN


@pytest.mark.parametrize("chunk", [0, 8])
def test_loss_matches_reference(ref, chunk):
    model, params = _port("qwen1.5-4b", ref["qwen"], loss_chunk=chunk)
    batch = {k: torch.as_tensor(v) for k, v in ref["qwen"]["inputs"].items()}
    loss, metrics = model.loss(params, batch)
    want_loss, want_ce = ref[f"loss{chunk}"]
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    assert abs(float(metrics["ce"]) - want_ce) <= 1e-5 * abs(want_ce)


def test_cpd_embedding_model_matches_reference(ref):
    """``cpd_embed_rank=8``: the embedding is the CPD lookup; its prefill
    and one decode step match the reference."""
    r = ref["cpd"]
    model, params = _port("qwen1.5-4b", r, cpd_embed_rank=8)
    assert "embed" not in params and set(params["embed_cpd"]) == {"A", "B", "C"}
    cache = model.init_cache(B, S + GEN, dtype=torch.float32, device="cpu")
    logits, cache = model.prefill(params, torch.as_tensor(r["inputs"]["tokens"]), cache)
    assert _rel(logits.numpy(), r["prefill"]) <= 1e-4
    logits, cache = model.decode_step(params, torch.tensor(r["greedy"][0])[:, None], cache)
    assert _rel(logits.numpy(), r["decode"][0]) <= 1e-4


@pytest.mark.parametrize("arch", OTHERS)
def test_other_dense_archs_match_reference(ref, arch):
    r = ref[arch]
    model, params = _port(arch, r)
    x = {k: torch.as_tensor(v) for k, v in r["inputs"].items()}
    full, _ = model.forward(params, x["tokens"], prefix_embeds=x.get("prefix_embeds"))
    assert _rel(full.numpy(), r["forward"]) <= 1e-4


@pytest.mark.parametrize("arch", ["qwen1.5-4b"] + OTHERS)
def test_decode_matches_forward(arch):
    """The port's own decode against its forward, at the reference's 5e-4
    (``test_arch_smoke.py::test_decode_matches_forward``)."""
    cfg = configs.reduce_config(configs.get_config(arch))
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    x = {k: torch.as_tensor(v) for k, v in _inputs(cfg, 1).items()}
    rel, shape = _decode_vs_forward(model, params, x["tokens"], x.get("prefix_embeds"))
    assert rel < 5e-4, f"{arch}: decode/forward mismatch rel={rel}"
    assert shape == (B, 1, cfg.padded_vocab)


def test_quantized_kv_decode_matches_reference(ref):
    """The int8 cache path against the reference's: the cache's int8 values
    and scales after a prefill and a decode step, and that step's logits.

    Inside its compiled layer scan, XLA's CPU backend keeps the
    dequantized cache ``ck.astype(bf16) * cks.astype(bf16)`` in float32
    (excess precision); the port rounds it to bfloat16 as the code is
    written (``test_torch_attention.py`` holds one eager decode step to
    1e-5).  So the second layer's input differs by that rounding: its new
    key moves an int8 value by at most one step, its scale and the logits
    by 1e-2 at most of themselves (1.6e-3 and 4.5e-3 measured)."""
    r = ref["int8"]
    model, params = _port("qwen1.5-32b", r)
    toks = torch.tensor(r["tokens"])
    cache = model.init_cache(B, S + GEN, dtype=torch.float32, quant_kv=True, device="cpu")
    _, cache = model.prefill(params, toks[:, :-1], cache)
    logits, cache = model.decode_step(params, toks[:, -1:], cache)
    assert _rel(logits.numpy(), r["decode"]) <= 1e-2
    np.testing.assert_array_equal(torch.argmax(logits, -1).numpy(),
                                  np.argmax(r["decode"], -1))
    want = r["cache"]["seg0_layers"]
    for name, got in cache["seg0_layers"].items():
        w = want[name].astype(np.float64)
        diff = np.abs(got.numpy().astype(np.float64) - w)
        if got.dtype == torch.int8:
            assert diff.max() <= 1, name
        else:
            assert (diff <= 1e-2 * np.abs(w) + 1e-9).all(), name


def test_quantized_kv_decode_close():
    """The int8 cache against the native one on reduced qwen1.5-32b: logits
    within 0.05 relative and argmax preserved (``test_arch_smoke.py``)."""
    model = get_model(configs.reduce_config(configs.get_config("qwen1.5-32b")))
    params = model.init(torch.Generator().manual_seed(2), "cpu")
    toks = torch.as_tensor(_inputs(model.cfg, 3)["tokens"])
    out = []
    for quant in (False, True):
        cache = model.init_cache(B, S + GEN, dtype=torch.float32, quant_kv=quant,
                                 device="cpu")
        _, cache = model.prefill(params, toks[:, :-1], cache)
        assert (cache["seg0_layers"]["k"].dtype == torch.int8) == quant
        out.append(model.decode_step(params, toks[:, -1:], cache)[0])
    a, b = out
    assert _rel(b.numpy(), a.numpy()) < 0.05
    assert torch.equal(torch.argmax(a, -1), torch.argmax(b, -1))

