"""Port vs JAX package in bfloat16, the configs' dtype, for the LM families
that ``chip_smoke.py`` serves in bf16: granite-moe-1b-a400m, mamba2-780m,
hymba-1.5b and whisper-large-v3, on the CPU.

Parameters are the reference's ``model.init`` draws in float32, cast to
the bf16 model's dtypes (a MoE router stays float32) on both sides, as
``chip_smoke.py`` casts them on the card.  The reference runs eagerly
(``jax.disable_jit``): inside a jitted function XLA's CPU backend keeps
the products of bf16 values in float32, eagerly it rounds each op as the
port does.  ``rel(a, b) = max|a - b| / max|b|``, taken per row (the
logits of one position of one sequence).

At reduced size (``reduce_config`` with dtype bfloat16): ``forward``
logits, and a prefill plus GEN decode steps (float32 cache, as the
launcher serves) teacher-forced with the reference's greedy tokens: at
least 90% of the rows within ``TOL_REDUCED[arch]`` of the reference's.
The random models amplify bf16 rounding, so a few rows lie farther: in
granite's forward one row of 34 (0.39; a top-2 choice of its router that
rounds the other way, expert probabilities 0.22817 and 0.22787 in the
reference), in mamba2's decode one of 10 (0.14).

The tolerances are about twice the errors these seeds give.
``test_torch_bf16_wide.py`` holds the same families at full width.
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
from repro_torch.convert import params_from_reference
from repro_torch.models import get_model

ARCHS = ["granite-moe-1b-a400m", "mamba2-780m", "hymba-1.5b", "whisper-large-v3"]
B, S, GEN = 2, 17, 4
TOL_REDUCED = {"granite-moe-1b-a400m": 2.5e-2, "mamba2-780m": 8e-2,
               "hymba-1.5b": 0.1, "whisper-large-v3": 2e-2}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _rows(got, want):
    """``rel`` of each row: the logits of one position of one sequence."""
    got = np.asarray(got, np.float64).reshape(-1, np.shape(want)[-1])
    want = np.asarray(want, np.float64).reshape(got.shape)
    return np.abs(got - want).max(-1) / np.abs(want).max(-1)


def _close(rows, tol: float) -> bool:
    """At least 90% of the rows within ``tol``."""
    return bool(np.mean(np.asarray(rows) > tol) <= 0.1)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _draw(rcfg, seed, batch, seq, redraw=None):
    """The reference's float32 draws (passed through ``redraw`` if given),
    their bf16 cast and numpy inputs (tokens, and Whisper's 0.1 x normal
    frames)."""
    m32 = rmodels.get_model(dataclasses.replace(rcfg, dtype="float32"))
    p32 = m32.init(jax.random.PRNGKey(seed))
    if redraw is not None:
        p32 = redraw(p32, seed)
    p16 = jax.tree.map(lambda x, a: x.astype(a.dtype), p32,
                       rmodels.get_model(rcfg).abstract_params())
    rng = np.random.default_rng(seed)
    x = {"tokens": rng.integers(0, rcfg.vocab_size, (batch, seq)).astype(np.int32)}
    if rcfg.family == "encdec":
        x["encoder_embeds"] = (0.1 * rng.standard_normal(
            (batch, rcfg.enc_seq, rcfg.d_model))).astype(np.float32)
    return p32, p16, x


def _forward_args(x, family, as_tensor):
    args = [as_tensor(x["tokens"])]
    if family == "encdec":
        args.append(as_tensor(x["encoder_embeds"]))
    return args


def _reference(arch, seed):
    """The reduced reference in bf16, eagerly: forward, prefill and GEN
    greedy decode steps."""
    rcfg = dataclasses.replace(rconfigs.reduce_config(rconfigs.get_config(arch)),
                               dtype="bfloat16")
    model = rmodels.get_model(rcfg)
    p32, p16, x = _draw(rcfg, seed, B, S)
    enc = {"encoder_embeds": jnp.asarray(x["encoder_embeds"])} \
        if rcfg.family == "encdec" else {}
    out = {"params": jax.tree.map(np.asarray, p16), "inputs": x}
    with jax.disable_jit():
        out["forward"] = _f32(model.forward(
            p16, *_forward_args(x, rcfg.family, jnp.asarray))[0])
        cache = model.init_cache(B, S + GEN, dtype=jnp.float32)
        logits, cache = model.prefill(p16, jnp.asarray(x["tokens"]), cache, **enc)
        out["prefill"], out["prefill_cache"] = _f32(logits), jax.tree.map(np.asarray, cache)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        out["greedy"], out["decode"] = [np.asarray(tok)], []
        for _ in range(GEN):
            logits, cache = model.decode_step(p16, tok[:, None], cache)
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
            out["decode"].append(_f32(logits))
            out["greedy"].append(np.asarray(tok))
    return out


@pytest.fixture(scope="module")
def ref():
    """Every reduced reference output this file compares with, computed once."""
    return {arch: _reference(arch, 50 + i) for i, arch in enumerate(ARCHS)}


def _port(cfg, params16):
    return get_model(cfg), params_from_reference(params16, "cpu")


def _reduced(arch):
    return dataclasses.replace(configs.reduce_config(configs.get_config(arch)),
                               dtype="bfloat16")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference(ref, arch):
    r = ref[arch]
    model, params = _port(_reduced(arch), r["params"])
    with torch.no_grad():
        full, _ = model.forward(params, *_forward_args(r["inputs"], model.cfg.family,
                                                       torch.as_tensor))
    assert full.dtype == torch.bfloat16
    rows = _rows(full.float().numpy(), r["forward"])
    assert _close(rows, TOL_REDUCED[arch]), np.round(rows, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_reference(ref, arch):
    """A bf16 prefill into a float32 cache, then GEN decode steps fed the
    reference's greedy tokens, each against the reference's logits."""
    r = ref[arch]
    model, params = _port(_reduced(arch), r["params"])
    enc = ({"encoder_embeds": torch.as_tensor(r["inputs"]["encoder_embeds"])}
           if model.cfg.family == "encdec" else {})
    cache = model.init_cache(B, S + GEN, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        logits, cache = model.prefill(params, torch.as_tensor(r["inputs"]["tokens"]),
                                      cache, **enc)
        rows = [_rows(logits.float().numpy(), r["prefill"])]
        for t in range(GEN):
            tok = torch.tensor(r["greedy"][t])[:, None]
            logits, cache = model.decode_step(params, tok, cache)
            rows.append(_rows(logits.float().numpy(), r["decode"][t]))
    rows = np.concatenate(rows)
    assert _close(rows, TOL_REDUCED[arch]), np.round(rows, 4)
    assert cache["pos"] == int(r["prefill_cache"]["pos"]) + GEN
