"""The port's LM ``Trainer`` and training launcher on the CPU, at reduced
sizes (reference ``tests/substrate/test_checkpoint_runtime.py``).

* 25 steps of reduced granite-moe-1b lower the loss, from the
  reference's parameter draws as in the reference's test.
* Crash and restart: the failure hook waits for the pending checkpoint
  (``trainer.ckpt.wait()``), then raises after step 8; a new trainer on
  the same directory resumes at step 9, and its losses of steps 9-12
  equal an uninterrupted run's bitwise (the reference's test races its
  asynchronous save against the crash, ``ROADMAP.md`` C-ref7).
* Two gloo ranks (``spawn_ranks``): a step at κ = 2 equals a step at
  κ = 1 on the same global batch within float32 tolerance, and the
  checkpoint the two ranks wrote restores on one rank and continues as
  the uninterrupted one-rank run does.
* The launcher: ``python -m repro_torch.launch.train --device cpu``
  prints the reference's last line (internvl2-1b, the default, and
  hymba-1.5b, whose reference train step is too slow to compile in the
  parity tests); ``--device cuda`` without a card raises.

The reference is imported inside the test that uses it, so that the
spawned ranks, which import this module, do not load JAX.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import TokenPipeline
from repro_torch.launch import make_host_mesh, spawn_ranks
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import make_trainer
from repro_torch.models import get_model
from repro_torch.runtime import Trainer

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 240.0
MESH_RUN = dict(steps=20, batch=4, seq=16, lr=1e-3, device="cpu")


def _granite_trainer(ckpt_dir, ckpt_every=5, failure_hook=None, seed=7):
    cfg = reduce_config(get_config("granite-moe-1b-a400m"))
    return Trainer(get_model(cfg), mesh=make_host_mesh(device="cpu"),
                   pipeline=TokenPipeline(cfg.vocab_size, batch=4, seq_len=24, seed=seed),
                   opt_cfg=optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50),
                   ckpt_dir=None if ckpt_dir is None else str(ckpt_dir),
                   ckpt_every=ckpt_every, failure_hook=failure_hook)


def _quiet(msg):
    pass


def test_loss_decreases():
    """The reference's test on its own data: the reference's parameter
    draws for seed 0 (``Trainer.initialize``'s default), from which the
    mean loss falls by about 0.004.  Which way 25 steps at this learning
    rate go depends on the draws: from the reference's seed 3, and from
    some of the port's own torch draws, the mean rises.  From the same
    draws the port tracks the reference's losses
    (``test_torch_train.py``)."""
    import jax

    from repro import models as rmodels
    from repro.configs import get_config as ref_config
    from repro.configs import reduce_config as ref_reduce
    from repro_torch.convert import params_from_reference

    tr = _granite_trainer(None)
    params = rmodels.get_model(ref_reduce(ref_config("granite-moe-1b-a400m"))).init(
        jax.random.PRNGKey(0))
    tr.params = params_from_reference(jax.tree.map(np.asarray, params), "cpu")
    tr.opt_state = optim.init_state(tr.params)
    h = tr.run(25, log_every=1000, log=_quiet)
    assert [r["step"] for r in h] == list(range(1, 26))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in h)
    first = np.mean([r["loss"] for r in h[:5]])
    last = np.mean([r["loss"] for r in h[-5:]])
    assert last < first, (first, last)
    assert tr.host_reads == 25 and tr.history == h


def test_crash_restart_bit_identical(tmp_path):
    class Boom(RuntimeError):
        pass

    tr = None

    def bomb(step):
        if step == 8:
            tr.ckpt.wait()          # the step-8 checkpoint is committed first
            raise Boom()

    tr = _granite_trainer(tmp_path / "c", ckpt_every=4, failure_hook=bomb)
    with pytest.raises(Boom):
        tr.run(12, log_every=1000, log=_quiet)
    assert tr.ckpt.latest_step() == 8
    tr2 = _granite_trainer(tmp_path / "c", ckpt_every=4)
    h2 = tr2.run(12, log_every=1000, log=_quiet)
    assert [r["step"] for r in h2] == [9, 10, 11, 12]

    tr3 = _granite_trainer(tmp_path / "u", ckpt_every=100)
    h3 = tr3.run(12, log_every=1000, log=_quiet)
    assert [r["loss"] for r in h2] == [r["loss"] for r in h3[8:]], \
        "restart must be bit-identical"
    for a, b in zip(_leaves(tr2.params), _leaves(tr3.params)):
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_trainer_refuses_a_pipeline_sliced_for_another_mesh():
    cfg = reduce_config(get_config("internvl2-1b"))
    with pytest.raises(ValueError, match="rank"):
        Trainer(get_model(cfg), mesh=make_host_mesh(device="cpu"),
                pipeline=TokenPipeline(cfg.vocab_size, batch=4, seq_len=8,
                                       process_index=1, process_count=2))


def rank_train(mesh, ckpt):
    """One rank of the κ = 2 run: two steps, a checkpoint after each."""
    tr = make_trainer(ckpt=ckpt, ckpt_every=1, mesh=make_host_mesh(device="cpu"),
                      **MESH_RUN)
    h = tr.run(2, log=_quiet)
    return {"history": [(r["loss"], r["grad_norm"]) for r in h],
            "mesh": (tr.mesh.axis_names, tr.mesh.size, tr.mesh.rank),
            "local_batch": tr.pipeline.local_batch}


def test_two_ranks_step_as_one_and_restore_on_one(tmp_path):
    ckpt = tmp_path / "kappa2"
    two = spawn_ranks(rank_train, 2, (str(ckpt),), timeout=SPAWN_TIMEOUT, device="cpu",
                      workdir=tmp_path / "spawn")
    assert [r["mesh"] for r in two] == [(("data",), 2, 0), (("data",), 2, 1)]
    assert [r["local_batch"] for r in two] == [2, 2]
    assert two[0]["history"] == two[1]["history"]   # every rank holds the same state

    one = make_trainer(**MESH_RUN)
    h1 = one.run(3, log=_quiet)
    np.testing.assert_allclose(two[0]["history"],
                               [(r["loss"], r["grad_norm"]) for r in h1[:2]], rtol=1e-5)

    # the checkpoint written at κ = 2 restores at κ = 1 and continues
    cont = make_trainer(ckpt=str(ckpt), **MESH_RUN)
    assert cont.initialize() == "restored" and cont.step == 2
    h = cont.run(3, log=_quiet)
    assert [r["step"] for r in h] == [3]
    np.testing.assert_allclose(h[0]["loss"], h1[2]["loss"], rtol=1e-5)
    assert int(cont.opt_state["step"]) == int(one.opt_state["step"]) == 3


@pytest.mark.parametrize("arch", ["internvl2-1b", "hymba-1.5b"])
def test_launcher_trains_on_the_cpu(arch, tmp_path):
    # one thread: the test shares the host with the other test workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "16", "--arch", arch,
         "--ckpt", str(tmp_path / "run"), "--ckpt-every", "2"],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith(f"[train] {arch}: loss ") and last.endswith("stragglers: 0"), last
    first, final = (float(x) for x in last.split("loss ")[1].split(";")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(final)
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "step_2", "step_2.done", "step_3", "step_3.done"]


def test_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would train")
    with pytest.raises(RuntimeError, match="cuda"):
        train_main(["--device", "cuda", "--steps", "1"])
