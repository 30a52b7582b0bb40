"""Port vs JAX package: the LM serving steps and launcher
(``repro_torch.launch.steps``, ``repro_torch.launch.serve``) on the CPU.

The prefill and greedy decode steps give the reference's token ids for
four steps on reduced qwen1.5-4b; ``generate`` fed its own tokens
(teacher forcing) repeats its run; the launcher runs as a module on the
CPU, for qwen1.5-4b and one arch of each other family, and exits 1 when
its decode SLO is breached; asking for the card
where there is none raises.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro.launch import steps as rsteps
from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve, steps
from repro_torch.models import get_model

ROOT = Path(__file__).resolve().parents[1]
B, P, GEN = 2, 9, 5


@pytest.fixture(scope="module")
def ref():
    """The reference's prefill and 4 greedy decode steps, computed once."""
    cfg = rconfigs.reduce_config(rconfigs.get_config("qwen1.5-4b"))
    model = rmodels.get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    cache = model.init_cache(B, P + GEN, dtype=jnp.float32)
    logits, cache = rsteps.make_prefill_step(model)(params, cache,
                                                    {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    decode = rsteps.make_decode_step(model)
    for _ in range(GEN - 1):
        tok, cache = decode(params, cache, {"tokens": tok[:, None]})
        toks.append(np.asarray(tok))
    return {"params": jax.tree.map(np.asarray, params), "prompts": prompts,
            "tokens": np.stack(toks, axis=1)}


def _port(r):
    model = get_model(configs.reduce_config(configs.get_config("qwen1.5-4b")))
    return model, params_from_reference(r["params"], "cpu")


def test_steps_give_the_reference_tokens(ref):
    model, params = _port(ref)
    cache = model.init_cache(B, P + GEN, dtype=torch.float32, device="cpu")
    logits, cache = steps.make_prefill_step(model)(
        params, cache, {"tokens": torch.as_tensor(ref["prompts"])})
    tok = steps.greedy(logits)
    toks = [tok]
    decode = steps.make_decode_step(model)
    for _ in range(GEN - 1):
        tok, cache = decode(params, cache, {"tokens": tok[:, None]})
        assert tok.dtype == torch.int32 and tok.shape == (B,)
        toks.append(tok)
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), ref["tokens"])


@pytest.mark.parametrize("quant_kv", [False, True], ids=["native", "int8"])
def test_generate_repeats_itself_under_teacher_forcing(ref, quant_kv):
    """``generate`` returns the reference's tokens (native cache) and,
    fed its own tokens, the same tokens and logits again."""
    model, params = _port(ref)
    prompts = torch.as_tensor(ref["prompts"])
    free, forced = [], []
    out = serve.generate(model, params, prompts, GEN, quant_kv=quant_kv, logits_out=free)
    assert out["tokens"].shape == (B, GEN) and len(free) == GEN
    assert out["prefill_ms"] > 0 and out["decode_ms_per_token"] > 0
    if not quant_kv:
        np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    again = serve.generate(model, params, prompts, GEN, quant_kv=quant_kv,
                           forced=torch.as_tensor(out["tokens"][:, :-1]), logits_out=forced)
    np.testing.assert_array_equal(again["tokens"], out["tokens"])
    for a, b in zip(free, forced):
        assert torch.equal(a, b)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.serve(batch=1, prompt_len=2, gen=2)


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--gen", "4", *args],
        env=env, capture_output=True, text=True, timeout=300)


def test_launcher_serves_on_the_cpu():
    proc = _launch()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[serve] qwen1.5-4b: batch=2 prompt=8 gen=4 kv=native" in proc.stdout
    assert "ms/tok" in proc.stdout and "RuntimeWarning" not in proc.stderr


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-780m", "hymba-1.5b",
                                  "whisper-large-v3"])
def test_launcher_serves_every_family_on_the_cpu(arch):
    """One arch of each family the dense-segment run above does not reach
    (moe, ssm, hybrid, encdec), reduced, with the int8 cache."""
    proc = _launch("--arch", arch, "--quant-kv")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"[serve] {arch}: batch=2 prompt=8 gen=4 kv=int8" in proc.stdout
    assert "ms/tok" in proc.stdout and "RuntimeWarning" not in proc.stderr


def test_launcher_exits_1_on_a_breached_decode_slo():
    proc = _launch("--slo-decode-ms", "1e-6")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "[health] breach" in proc.stdout
