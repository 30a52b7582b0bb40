"""Port vs JAX package: LM training on the CPU in float32 at reduced sizes
-- the sharding rules, the train step and the Trainer.

* Sharding rules (``models.common``, ``launch.shardings``): every
  parameter's resolved spec equals the reference's ``resolve_pspec`` over
  ``param_axes()`` for reduced internvl2-1b and granite-moe-1b on meshes
  of 1 and 2 along ``data`` (and a 2 x 4 ``data`` x ``model`` mesh); the
  reference is called with a stand-in mesh carrying ``axis_names`` and
  ``devices.shape``, all it reads.
* Gradients and one step, per family: internvl2-1b (no prefix, the
  launcher's edit), qwen1.5-4b with ``cpd_embed_rank`` and with
  ``loss_chunk``, granite-moe-1b (capacity dispatch, aux loss),
  mamba2-780m and whisper-large-v3.  The port's model runs with
  ``remat="full"`` (its per-layer checkpoint; the reference's reduced
  configs say ``none``, which changes no value).  Loss within 1e-6
  relative; every gradient within 1e-5 of the largest gradient entry
  (``GRAD_TOL``) against ``jax.value_and_grad`` of the reference's
  ``model.loss``.  After one step against the reference's jitted
  ``make_train_step``: the moments within 1e-5 of their largest entry,
  ``grad_norm`` within 1e-5 relative, ``lr`` and the step count equal,
  and every parameter within the bound that the gradient tolerance
  allows (``_update_bound``).  Hymba is left to the launcher's CPU
  smoke: its reference train step takes about 30 s to compile.
* Microbatch: ``microbatch=2`` gradients equal ``microbatch=1``'s within
  ``GRAD_TOL``, and its step equals the reference's ``microbatch=2``.
* Remat: ``remat="full"`` and ``"dots"`` give bitwise the loss and
  gradients of ``remat="none"`` for every family, hymba too, through one
  checkpoint per layer (and per loss chunk).
* Trainer: from the reference's parameters and optimizer state the port's
  ``Trainer`` tracks the reference ``Trainer``'s losses over 5 steps
  within 1e-5 relative.

Each reference runs once per arch, jitted, in a module-scoped cache;
parameters are its ``model.init`` draws, carried by
``params_from_reference``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import models as rmodels
from repro import optim as roptim
from repro.launch import steps as rsteps
from repro.models import common as rcommon
from repro_torch import configs, optim
from repro_torch.convert import adamw_state_from_reference, params_from_reference
from repro_torch.launch import shardings, steps
from repro_torch.models import common, get_model
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod

B, S = 2, 24
GRAD_TOL = 1e-5
# (test id, arch, config edits) of the families held to the reference's step.
FAMILIES = [
    ("internvl2-1b", "internvl2-1b", {"num_prefix_tokens": 0}),
    ("qwen-cpd", "qwen1.5-4b", {"cpd_embed_rank": 8}),
    ("qwen-chunked", "qwen1.5-4b", {"loss_chunk": 8}),
    ("granite-moe", "granite-moe-1b-a400m", {}),
    ("mamba2", "mamba2-780m", {}),
    ("whisper", "whisper-large-v3", {}),
]
REMAT_FAMILIES = FAMILIES + [("hymba", "hymba-1.5b", {})]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, prefix=""):
    """{path: numpy leaf} of a tree of dicts (either package's)."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items() for p, v in _paths(t, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree,
                               np.float64)}


def _cfgs(arch, edits):
    return (dataclasses.replace(rconfigs.reduce_config(rconfigs.get_config(arch)), **edits),
            dataclasses.replace(configs.reduce_config(configs.get_config(arch)), **edits))


def _batch(cfg, seed, batch=B, ignored=True):
    """Seeded inputs; ``ignored`` sets one label to -1 (ignored).  A batch
    split into microbatches keeps every label, so that each microbatch's
    mean loss counts as many tokens and their mean is the batch's."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)}
    if ignored:
        out["labels"][0, 3] = -1
    if cfg.enc_layers:
        out["encoder_embeds"] = 0.1 * rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class _StandInMesh:
    """What the reference's ``resolve_pspec`` reads of a mesh."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = types.SimpleNamespace(shape=tuple(sizes.values()))


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

MESHES = [{"data": 1}, {"data": 2}, {"data": 2, "model": 4}]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("arch,edits", [("internvl2-1b", {"num_prefix_tokens": 0}),
                                        ("granite-moe-1b-a400m", {})])
def test_param_shardings_match_the_reference(arch, edits, mesh):
    rcfg, pcfg = _cfgs(arch, edits)
    rmodel, pmodel = rmodels.get_model(rcfg), get_model(pcfg)
    stand_in = _StandInMesh(mesh)
    want = jax.tree.map(
        lambda ax, a: tuple(rcommon.resolve_pspec(ax, a.shape, stand_in)),
        rmodel.param_axes(), rmodel.abstract_params(),
        is_leaf=lambda x: isinstance(x, tuple))
    got = shardings.param_shardings(pmodel, mesh)
    assert _flat_specs(got) == _flat_specs(want)
    opt = shardings.opt_state_shardings(got, mesh)
    assert opt["mu"] is got and opt["nu"] is got and opt["step"] == ()


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items() for p, v in _flat_specs(t, f"{prefix}/{k}").items()}
    return {prefix: tuple(tree)}


def test_rules_match_the_reference():
    assert common.get_rules() == rcommon.get_rules()
    axes = ("batch", "fsdp", "tensor", "experts", "vocab", "layers", None, "seq")
    assert common.to_pspec(axes) == tuple(rcommon.to_pspec(axes))
    mesh = {"pod": 2, "data": 4, "model": 8}
    for shape in [(8, 64, 64, 16, 32, 3, 5, 7), (6, 6, 12, 8, 16, 1, 1, 1)]:
        assert common.resolve_pspec(axes, shape, mesh) == tuple(
            rcommon.resolve_pspec(axes, shape, _StandInMesh(mesh)))
    try:
        common.set_rules(seq="data")
        rcommon.set_rules(seq="data")
        assert common.get_rules() == rcommon.get_rules()
        assert common.resolve_pspec(("seq",), (8,), mesh) == ("data",)
    finally:
        common.reset_rules()
        rcommon.reset_rules()
    assert common.get_rules() == rcommon.get_rules()
    x = torch.ones(2, 3)
    assert common.constrain(x, "batch", None) is x


def test_batch_and_cache_shardings():
    specs = {"tokens": torch.empty(8, 16), "labels": torch.empty(8, 16)}
    assert shardings.batch_shardings(specs, {"data": 2}) == {
        "tokens": ("data", None), "labels": ("data", None)}
    assert shardings.batch_shardings(specs, {"data": 3})["tokens"] == (None, None)
    assert shardings.batch_shardings(specs, {"data": 1, "model": 4})["tokens"] == ("data", None)
    cache = {"pos": 5, "seg": {"k": torch.empty(2, 4, 2048, 2, 16),
                               "ring": torch.empty(4, 16, 2)}}
    got = shardings.cache_shardings(cache, {"data": 2}, seq_axis_ok=True)
    assert got == {"pos": (), "seg": {"k": (None, "data", None, None, None),
                                      "ring": ("data", None, None)}}
    # batch 1 long context: the cache's sequence dim takes the data axis
    long = {"k": torch.empty(2, 1, 2048, 2, 16)}
    assert shardings.cache_shardings(long, {"data": 2}, seq_axis_ok=True) == {
        "k": (None, None, "data", None, None)}
    assert shardings.cache_shardings(long, {"data": 2, "model": 2}, seq_axis_ok=False,
                                     kv_model_axis=True) == {
        "k": (None, None, None, "model", None)}


# ---------------------------------------------------------------------------
# Gradients and one step against the reference
# ---------------------------------------------------------------------------


def _reference(arch, edits, seed, microbatch=1, batch=B):
    rcfg, _ = _cfgs(arch, edits)
    model = rmodels.get_model(rcfg)
    params = model.init(jax.random.PRNGKey(seed))
    x = _batch(rcfg, seed, batch, ignored=microbatch == 1)
    (loss, _), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        params, _jax_batch(x))
    opt_cfg = roptim.AdamWConfig(**OPT)
    step = jax.jit(rsteps.make_train_step(model, opt_cfg, microbatch=microbatch))
    p2, o2, m2 = step(params, roptim.init_state(params), _jax_batch(x))
    return {"params": _np_tree(params), "inputs": x, "loss": float(loss),
            "grads": _np_tree(grads), "step_params": _np_tree(p2),
            "step_opt": _np_tree(o2), "step_metrics": {k: float(v) for k, v in m2.items()}}


@pytest.fixture(scope="module")
def ref():
    """Reference results by test id, each computed on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            if name == "microbatch":
                cache[name] = _reference("internvl2-1b", {"num_prefix_tokens": 0}, 7,
                                         microbatch=2, batch=4)
            else:
                i, (_, arch, edits) = next((i, f) for i, f in enumerate(FAMILIES)
                                           if f[0] == name)
                cache[name] = _reference(arch, edits, 40 + i)
        return cache[name]

    return get


def _port(name, r, remat="full"):
    _, arch, edits = next(f for f in REMAT_FAMILIES if f[0] == name)
    _, pcfg = _cfgs(arch, {**edits, "remat": remat})
    return get_model(pcfg), params_from_reference(r["params"], "cpu")


def _assert_grads_close(got, want):
    got, want = _paths(got), _paths(want)
    assert got.keys() == want.keys()
    scale = max(np.abs(v).max() for v in want.values())
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    assert worst <= GRAD_TOL * scale, (worst, scale)


def _update_bound(g_ref, grad_norm, lr, eps):
    """The largest difference between the port's and the reference's
    parameters after AdamW's first step that a gradient error within
    ``GRAD_TOL`` of the largest entry allows.  From zero moments the
    update of an entry is lr·ĝ/(|ĝ| + eps) with ĝ the clipped gradient,
    and a change δ of ĝ moves it by at most lr·δ/(max(|ĝ| - δ, 0) + eps),
    never more than 2·lr: tight where |ĝ| is far above δ, up to 2·lr for
    an entry whose gradient is about zero."""
    scale = min(1.0, 1.0 / max(grad_norm, 1e-9))          # grad_clip = 1
    delta = GRAD_TOL * max(np.abs(v).max() for v in g_ref.values()) * scale
    return {k: lr * np.minimum(2.0, delta / (np.maximum(np.abs(g) * scale - delta, 0) + eps))
            for k, g in g_ref.items()}


def _assert_step_close(p2, o2, m2, r, lr=None):
    rm = r["step_metrics"]
    assert abs(float(m2["grad_norm"]) - rm["grad_norm"]) <= 1e-5 * rm["grad_norm"]
    assert float(m2["lr"]) == pytest.approx(rm["lr"], rel=1e-7)
    assert int(o2["step"]) == int(r["step_opt"]["step"]) == 1
    for name in ("mu", "nu"):
        _assert_grads_close(o2[name], r["step_opt"][name])
    got, want = _paths(p2), _paths(r["step_params"])
    assert got.keys() == want.keys()
    bound = _update_bound(_paths(r["grads"]), rm["grad_norm"], rm["lr"], 1e-8)
    pmax = max(np.abs(v).max() for v in want.values())
    for k in want:
        err = np.abs(got[k] - want[k])
        assert (err <= 1e-6 * pmax + bound[k]).all(), (k, err.max())


@pytest.mark.parametrize("name", [f[0] for f in FAMILIES])
def test_loss_and_gradients_match_value_and_grad(ref, name):
    r = ref(name)
    model, params = _port(name, r)
    grads, metrics = steps.make_grad_fn(model)(params, _torch_batch(r["inputs"]))
    assert abs(float(metrics["loss"]) - r["loss"]) <= 1e-6 * abs(r["loss"])
    _assert_grads_close(grads, r["grads"])
    for k, g in _paths(grads).items():
        assert np.isfinite(g).all(), k


@pytest.mark.parametrize("name", [f[0] for f in FAMILIES])
def test_one_step_matches_the_reference_step(ref, name):
    r = ref(name)
    model, params = _port(name, r)
    before = {k: v.clone() for k, v in _flat_tensors(params).items()}
    step = steps.make_train_step(model, optim.AdamWConfig(**OPT))
    p2, o2, m2 = step(params, optim.init_state(params), _torch_batch(r["inputs"]))
    _assert_step_close(p2, o2, m2, r)
    assert float(m2["loss"]) == pytest.approx(r["step_metrics"]["loss"], rel=1e-6)
    # the inputs are left as they were
    assert all(torch.equal(before[k], v) for k, v in _flat_tensors(params).items())


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items() for p, v in _flat_tensors(t, f"{prefix}/{k}").items()}
    return {prefix: tree}


def test_microbatch_matches_one_batch_and_the_reference(ref):
    r = ref("microbatch")
    _, pcfg = _cfgs("internvl2-1b", {"num_prefix_tokens": 0, "remat": "full"})
    model = get_model(pcfg)
    params = params_from_reference(r["params"], "cpu")
    batch = _torch_batch(r["inputs"])
    g1, m1 = steps.make_grad_fn(model)(params, batch)
    g2, m2 = steps.make_grad_fn(model, microbatch=2)(params, batch)
    assert set(m2) == {"loss"}
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert all(g.dtype == torch.float32 for g in _flat_tensors(g2).values())
    _assert_grads_close(g2, _np_tree_of(g1))
    _assert_grads_close(g2, r["grads"])          # the reference's one batch
    step = steps.make_train_step(model, optim.AdamWConfig(**OPT), microbatch=2)
    p2, o2, m = step(params, optim.init_state(params), batch)
    _assert_step_close(p2, o2, m, r)
    assert float(m["loss"]) == pytest.approx(r["step_metrics"]["loss"], rel=1e-6)
    with pytest.raises(ValueError):
        steps.make_grad_fn(model, microbatch=3)(params, batch)


def _np_tree_of(tree):
    return {k: _np_tree_of(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree.detach().numpy()


# ---------------------------------------------------------------------------
# Remat: a per-layer checkpoint, bitwise the plain pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [f[0] for f in REMAT_FAMILIES])
def test_remat_is_bitwise_the_plain_pass(name, monkeypatch):
    _, arch, edits = next(f for f in REMAT_FAMILIES if f[0] == name)
    _, cfg = _cfgs(arch, edits)
    batch = _torch_batch(_batch(cfg, 3))
    calls = []

    def counting(fn, *args):
        calls.append(fn)
        return common.remat(fn, *args)

    monkeypatch.setattr(lm_mod, "remat", counting)
    monkeypatch.setattr(encdec_mod, "remat", counting)
    out = {}
    for remat in ("none", "full", "dots"):
        model = get_model(dataclasses.replace(cfg, remat=remat))
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        calls.clear()
        grads, metrics = steps.make_grad_fn(model)(params, batch)
        out[remat] = (metrics["loss"], _flat_tensors(grads), len(calls))
    chunks = -(-S // cfg.loss_chunk) if cfg.loss_chunk else 0
    layers = cfg.num_layers + (cfg.enc_layers if cfg.family == "encdec" else 0)
    assert out["none"][2] == chunks
    for remat in ("full", "dots"):
        loss, grads, n = out[remat]
        assert n == layers + chunks
        assert torch.equal(loss, out["none"][0])
        assert all(torch.equal(g, out["none"][1][k]) for k, g in grads.items())
    # serving records no graph: no checkpoint, whatever remat says
    model = get_model(dataclasses.replace(cfg, remat="full"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    calls.clear()
    if cfg.family == "encdec":
        model.forward(params, batch["tokens"], batch["encoder_embeds"])
    else:
        model.forward(params, batch["tokens"])
    assert not calls


# ---------------------------------------------------------------------------
# The Trainer against the reference's
# ---------------------------------------------------------------------------


def test_trainer_tracks_the_reference_trainer():
    """Five steps of reduced granite-moe-1b (capacity dispatch) from the
    reference's initial parameters and optimizer state, on the same
    pipeline: every loss within 1e-5 relative."""
    from repro.data import TokenPipeline as RefPipeline
    from repro.launch.mesh import make_host_mesh as ref_mesh
    from repro.runtime import Trainer as RefTrainer

    from repro_torch.data import TokenPipeline
    from repro_torch.launch import make_host_mesh
    from repro_torch.runtime import Trainer

    rcfg, pcfg = _cfgs("granite-moe-1b-a400m", {})
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    rtr = RefTrainer(rmodels.get_model(rcfg), mesh=ref_mesh(),
                     pipeline=RefPipeline(rcfg.vocab_size, batch=4, seq_len=24, seed=7),
                     opt_cfg=roptim.AdamWConfig(**opt))
    rtr.initialize(seed=3)
    params0, opt0 = _np_tree(rtr.params), _np_tree(rtr.opt_state)
    want = [h["loss"] for h in rtr.run(5, log_every=1000, log=lambda s: None)]

    ptr = Trainer(get_model(pcfg), mesh=make_host_mesh(device="cpu"),
                  pipeline=TokenPipeline(pcfg.vocab_size, batch=4, seq_len=24, seed=7),
                  opt_cfg=optim.AdamWConfig(**opt))
    ptr.params = params_from_reference(params0, "cpu")
    ptr.opt_state = adamw_state_from_reference(opt0, "cpu")
    got = [h["loss"] for h in ptr.run(5, log_every=1000, log=lambda s: None)]
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert ptr.host_reads == 5
