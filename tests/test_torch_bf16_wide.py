"""Port vs JAX package in bfloat16 at full width, for the LM families that
``chip_smoke.py`` serves in bf16: granite-moe-1b-a400m, mamba2-780m,
hymba-1.5b and whisper-large-v3, on the CPU.

One layer (whisper one encoder and one decoder layer) at the config's
full width, B_WIDE x S_WIDE tokens: the port's bf16 ``forward`` logits
within ``TOL_WIDE[arch]`` of the reference's bf16 (``rel`` over all the
positions at once), with
the reference run eagerly and the parameters its float32 draws cast to
bf16, as ``test_torch_bf16.py`` sets out.  The tolerances are about twice
the errors this seed gives (0.006 to 0.011).

``PYTHONPATH=src python tests/test_torch_bf16_wide.py [layers ...]``
prints, at full width and each depth (default 1, 2, 4), on B_DRIFT x
S_DRIFT tokens, the median, 90th percentile and largest row ``rel`` of
the reference's bf16 ``forward`` against its float32 one, beside the
port's bf16 against both, and the same for granite with its expert weights redrawn at std
1/sqrt(fan-in) in place of the reference's 1/sqrt(E) (``common.py``
takes fan-in from a weight's first axis).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro_torch import configs
from test_torch_bf16 import ARCHS, _draw, _f32, _forward_args, _port, _rows

B_WIDE, S_WIDE = 2, 16
B_DRIFT, S_DRIFT = 4, 64           # the printed drift: 256 rows a depth
TOL_WIDE = {"granite-moe-1b-a400m": 1.5e-2, "mamba2-780m": 2.5e-2,
            "hymba-1.5b": 2.5e-2, "whisper-large-v3": 1.5e-2}


def _rescale_experts(tree, seed):
    """Expert weights (E, fan-in, fan-out) redrawn with std 1/sqrt(fan-in)
    in place of the reference's 1/sqrt(E)."""
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1), 64))

    def walk(t):
        if not isinstance(t, dict):
            return t
        if {"router", "wi", "wg", "wo"} <= set(t):
            return {k: (jax.random.normal(next(keys), v.shape) / np.sqrt(v.shape[-2])
                        if k != "router" else v) for k, v in t.items()}
        return {k: walk(v) for k, v in t.items()}
    return walk(tree)


def _cut(cfg, layers: int):
    """``cfg`` at full width with ``layers`` layers (and as many encoder
    layers; hymba's global layers the first and the last)."""
    kw = {"num_layers": layers}
    if cfg.family == "hybrid":
        kw["global_attn_layers"] = (0, layers - 1) if layers > 1 else (0,)
    if cfg.enc_layers:
        kw["enc_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def drift(arch, layers, seed=0, rescale_experts=False, float32=True,
          batch=B_WIDE, seq=S_WIDE) -> dict:
    """At full width with ``layers`` layers, ``rel`` of each row (a
    position of a sequence): the port's bf16 ``forward`` against the
    reference's, and with ``float32`` both against the reference's
    float32 ``forward``."""
    rcfg = _cut(rconfigs.get_config(arch), layers)
    p32, p16, x = _draw(rcfg, seed, batch, seq,
                        _rescale_experts if rescale_experts else None)
    with jax.disable_jit():
        r16 = _f32(rmodels.get_model(rcfg).forward(
            p16, *_forward_args(x, rcfg.family, jnp.asarray))[0])
    model, params = _port(_cut(configs.get_config(arch), layers),
                          jax.tree.map(np.asarray, p16))
    with torch.no_grad():
        got = model.forward(params, *_forward_args(x, rcfg.family, torch.as_tensor))[0]
    got = got.float().numpy()
    out = {"port_bf16_vs_reference_bf16": _rows(got, r16)}
    if float32:
        r32 = _f32(jax.jit(rmodels.get_model(dataclasses.replace(
            rcfg, dtype="float32")).forward)(p32, *_forward_args(x, rcfg.family, jnp.asarray))[0])
        out.update(reference_bf16_vs_float32=_rows(r16, r32),
                   port_bf16_vs_float32=_rows(got, r32))
    return out


def _quantiles(rows) -> str:
    return "median %.4f, 90%% %.4f, max %.4f" % tuple(np.quantile(rows, [0.5, 0.9, 1.0]))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_full_width_layer_matches_reference(arch):
    rows = drift(arch, 1, seed=60, float32=False)["port_bf16_vs_reference_bf16"]
    assert rows.max() <= TOL_WIDE[arch], np.round(rows, 4)


if __name__ == "__main__":
    # The drift of bf16 from float32 at full width, by depth.
    depths = [int(a) for a in sys.argv[1:]] or [1, 2, 4]
    runs = [(arch, False) for arch in ARCHS] + [(ARCHS[0], True)]
    for arch, rescale in runs:
        for n in depths:
            d = drift(arch, n, rescale_experts=rescale, batch=B_DRIFT, seq=S_DRIFT)
            name = arch + (", experts at 1/sqrt(fan-in)" if rescale else "")
            for k, rows in d.items():
                print(f"{name}, {n} layers, {k}: {_quantiles(rows)}", flush=True)
