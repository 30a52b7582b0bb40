"""Port vs JAX package: the architecture configs and the shape registry
(``repro_torch.configs``, ``repro_torch.models.base``, ``model_segments``).

Pure arithmetic, no JAX compute: for each of the ten archs the port's
``get_config`` and ``reduce_config`` equal the reference's field by
field, and so do ``padded_vocab``, ``param_count``,
``active_param_count``, ``model_segments`` (which both refuse the
``encdec`` family) and ``shape_applicable`` on each of the four
``SHAPES``.  For every arch ``token_specs`` gives the reference's shapes
and dtypes, and so do the model's abstract parameters (``LM`` with a
dense and a CPD-factorized embedding, ``EncDec``), with the reference's
logical axes.
"""
import dataclasses

import pytest
import torch

from repro import configs as rconfigs
from repro.models import base as rbase
from repro import models as rmodels
from repro.models import lm as rlm
from repro_torch import configs
from repro_torch.models import base, get_model
from repro_torch.models import lm

ARCHS = list(rconfigs.ARCHS)
DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _derived(cfg) -> dict:
    return {"padded_vocab": cfg.padded_vocab, "param_count": cfg.param_count(),
            "active_param_count": cfg.active_param_count(),
            "d_inner": cfg.d_inner, "is_subquadratic": cfg.is_subquadratic}


def test_registry_lists_the_reference_archs():
    assert configs.ARCHS == rconfigs.ARCHS and len(configs.ARCHS) == 10
    assert configs.SHAPES == {k: base.ShapeCfg(**dataclasses.asdict(v))
                              for k, v in rbase.SHAPES.items()}
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, reduced):
    ref, got = rconfigs.get_config(arch), configs.get_config(arch)
    if reduced:
        ref, got = rconfigs.reduce_config(ref), configs.reduce_config(got)
    assert _fields(got) == _fields(ref)
    assert _derived(got) == _derived(ref)
    assert got.param_dtype == DTYPES[str(ref.param_dtype.dtype)]
    if ref.family == "encdec":      # whisper's decoder is built by encdec.py
        for segments, c in ((rlm.model_segments, ref), (lm.model_segments, got)):
            with pytest.raises(ValueError, match="encdec"):
                segments(c)
        return
    segs = [dataclasses.astuple(s) for s in lm.model_segments(got)]
    assert segs == [dataclasses.astuple(s) for s in rlm.model_segments(ref)]


def test_reduce_config_overrides_match_reference():
    kw = dict(num_layers=4, d_model=128, num_heads=8, num_kv_heads=4, head_dim=16,
              d_ff=512, vocab_size=4096, cpd_embed_rank=8)
    ref = rconfigs.reduce_config(rconfigs.get_config("qwen1.5-4b"), **kw)
    got = configs.reduce_config(configs.get_config("qwen1.5-4b"), **kw)
    assert _fields(got) == _fields(ref) and _derived(got) == _derived(ref)


@pytest.mark.parametrize("shape", list(rbase.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_matches_reference(arch, shape):
    ref = rbase.shape_applicable(rconfigs.get_config(arch), rbase.SHAPES[shape])
    got = base.shape_applicable(configs.get_config(arch), base.SHAPES[shape])
    assert got == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_token_specs_match_reference(arch):
    for name in rbase.SHAPES:
        ref = rbase.token_specs(rconfigs.get_config(arch), rbase.SHAPES[name])
        got = base.token_specs(configs.get_config(arch), base.SHAPES[name])
        assert list(got) == list(ref), name
        for k, spec in ref.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(spec.shape), (name, k)
            assert got[k].dtype == DTYPES[str(spec.dtype)], (name, k)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flatten(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("cpd_rank", [0, 256], ids=["dense_embed", "cpd_embed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch, cpd_rank):
    rcfg = dataclasses.replace(rconfigs.get_config(arch), cpd_embed_rank=cpd_rank)
    cfg = dataclasses.replace(configs.get_config(arch), cpd_embed_rank=cpd_rank)
    ref, model = rmodels.get_model(rcfg), get_model(cfg)
    want, got = _flatten(ref.abstract_params()), _flatten(model.abstract_params())
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert got[k].dtype == DTYPES[str(spec.dtype)], k
    assert _flatten(model.param_axes()) == _flatten(ref.param_axes())
