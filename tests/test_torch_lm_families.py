"""Port vs JAX package: the LM's MoE, SSM and hybrid families
(``repro_torch.models.lm`` over the ``moe``, ``mamba`` and ``hymba``
blocks) on the CPU, in float32 at reduced sizes.

For reduced granite-moe-1b-a400m, dbrx-132b, mamba2-780m and hymba-1.5b:
``forward`` logits, a prefill's logits and every leaf of its cache (KV,
SSM state, conv window; hymba's sliding-window segments as rings), four
decode steps teacher-forced with the reference's greedy tokens (logits
and argmax), and the loss (for MoE with the capacity dispatch and its
aux loss), all within 1e-4 relative.  Each arch decodes as its own
``forward`` within the reference's 5e-4.  Hymba's 4 meta tokens and 17
prompt tokens exceed its reduced window of 16, so its rings wrap in the
prefill; its int8 cache stays within 0.05 of the native one with the
argmax kept (``test_arch_smoke.py``'s bound).
``rel(a, b) = max|a - b| / max|b|``, the reference's own measure.  The
reference runs once per arch, jitted, in a module-scoped fixture;
parameters are its ``model.init`` draws, carried by
``params_from_reference``.
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
from repro_torch.models import get_model

B, S, GEN = 2, 17, 4
ARCHS = ["granite-moe-1b-a400m", "dbrx-132b", "mamba2-780m", "hymba-1.5b"]
TOL = 1e-4


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
    return out


def _reference(arch, seed):
    """The reference's forward, loss, prefill and GEN greedy decode steps."""
    cfg = rconfigs.reduce_config(rconfigs.get_config(arch))
    model = rmodels.get_model(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    x = _inputs(cfg, seed)
    toks = jnp.asarray(x["tokens"])
    out = {"params": _np_tree(params), "inputs": x}
    out["forward"] = np.asarray(jax.jit(model.forward)(params, toks)[0])
    loss, metrics = jax.jit(model.loss)(params, {k: jnp.asarray(v) for k, v in x.items()})
    out["loss"] = {k: float(v) for k, v in metrics.items()}
    cache = model.init_cache(B, S + GEN, dtype=jnp.float32)
    logits, cache = jax.jit(model.prefill)(params, toks, cache)
    out["prefill"], out["prefill_cache"] = np.asarray(logits), _np_tree(cache)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    out["greedy"], out["decode"] = [np.asarray(tok)], []
    decode = jax.jit(model.decode_step)
    for _ in range(GEN):
        logits, cache = decode(params, tok[:, None], cache)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        out["decode"].append(np.asarray(logits))
        out["greedy"].append(np.asarray(tok))
    return out


@pytest.fixture(scope="module")
def ref():
    """Every reference output this file compares with, computed once."""
    return {arch: _reference(arch, 20 + i) for i, arch in enumerate(ARCHS)}


def _port(arch, r):
    cfg = configs.reduce_config(configs.get_config(arch))
    return get_model(cfg), params_from_reference(r["params"], "cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() if k != "pos"
                for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(ref, arch):
    r = ref[arch]
    model, params = _port(arch, r)
    full, aux = model.forward(params, torch.as_tensor(r["inputs"]["tokens"]))
    assert full.shape == (B, S, model.cfg.padded_vocab)
    assert aux.dtype == torch.float32 and aux.ndim == 0
    assert _rel(full.numpy(), r["forward"]) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(ref, arch):
    """The loss and its parts; for MoE the capacity dispatch and the
    summed aux loss of every block."""
    r = ref[arch]
    model, params = _port(arch, r)
    _, metrics = model.loss(params, {k: torch.as_tensor(v) for k, v in r["inputs"].items()})
    for name, want in r["loss"].items():
        got = float(metrics[name])
        assert abs(got - want) <= 1e-5 * abs(want), name
    assert (r["loss"]["aux"] > 0) == (model.cfg.family == "moe")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_cache_match_reference(ref, arch):
    r = ref[arch]
    model, params = _port(arch, r)
    cache = model.init_cache(B, S + GEN, dtype=torch.float32, device="cpu")
    bufs = _leaves(cache)
    logits, cache = model.prefill(params, torch.as_tensor(r["inputs"]["tokens"]), cache)
    assert _rel(logits.numpy(), r["prefill"]) <= TOL
    assert cache["pos"] == int(r["prefill_cache"]["pos"])
    got, want = _leaves(cache), _leaves(cache_from_reference(r["prefill_cache"], "cpu"))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name] is bufs[name], name                   # written in place
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        assert _rel(got[name].numpy(), w.numpy()) <= TOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(ref, arch):
    """GEN decode steps fed the reference's greedy tokens: logits within
    1e-4 and the port's argmax equal to the reference's at every step."""
    r = ref[arch]
    model, params = _port(arch, r)
    cache = cache_from_reference(r["prefill_cache"], "cpu")
    for t in range(GEN):
        tok = torch.tensor(r["greedy"][t])[:, None]
        logits, cache = model.decode_step(params, tok, cache)
        assert _rel(logits.numpy(), r["decode"][t]) <= TOL, t
        np.testing.assert_array_equal(torch.argmax(logits[:, -1], -1).numpy(),
                                      r["greedy"][t + 1])
    assert cache["pos"] == int(r["prefill_cache"]["pos"]) + GEN


def _decode_vs_forward(model, params, toks, quant=False):
    """The port's decode of the last GEN tokens after a prefill of the
    others, each step against its own ``forward`` on the whole sequence."""
    full, _ = model.forward(params, toks)
    cache = model.init_cache(B, S, dtype=torch.float32, quant_kv=quant, device="cpu")
    _, cache = model.prefill(params, toks[:, :S - GEN], cache)
    steps = []
    for t in range(S - GEN, S):
        dec, cache = model.decode_step(params, toks[:, t:t + 1], cache)
        steps.append((dec, full[:, t:t + 1]))
    return steps


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own decode against its forward, at the reference's 5e-4
    (``test_arch_smoke.py::test_decode_matches_forward``), over 4 steps."""
    cfg = configs.reduce_config(configs.get_config(arch))
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    toks = torch.as_tensor(_inputs(cfg, 1)["tokens"])
    for dec, full in _decode_vs_forward(model, params, toks):
        assert dec.shape == (B, 1, cfg.padded_vocab)
        rel = _rel(dec.numpy(), full.numpy())
        assert rel < 5e-4, f"{arch}: decode/forward mismatch rel={rel}"


def test_hymba_int8_cache_close():
    """The int8 cache against the native one on reduced hymba, every step
    of a decode whose sliding-window rings have wrapped: logits within
    0.05 relative and the argmax kept."""
    cfg = configs.reduce_config(configs.get_config("hymba-1.5b"))
    assert cfg.num_meta_tokens + S - GEN > cfg.attn_window
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(2), "cpu")
    toks = torch.as_tensor(_inputs(cfg, 3)["tokens"])
    native = _decode_vs_forward(model, params, toks)
    quant = _decode_vs_forward(model, params, toks, quant=True)
    for (a, _), (b, _) in zip(native, quant):
        assert _rel(b.numpy(), a.numpy()) < 0.05
        assert torch.equal(torch.argmax(a, -1), torch.argmax(b, -1))
