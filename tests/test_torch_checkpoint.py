"""The port's checkpoint manager: the reference's contract (atomic commit
behind a marker, keep-k, torn checkpoints pruned, template and
template-free restore) in a format of the port's own (one ``.npz`` of
leaves keyed by path and a JSON sidecar).  A checkpoint written by the
reference's manager is refused, not misread."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as mgr_mod


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.standard_normal((4, 6)).astype(np.float32),
        "nested": {"b": np.arange(5, dtype=np.int32),
                   "t": torch.as_tensor(rng.standard_normal(3))},
        "seq": [np.float64(2.5), (np.zeros((2, 2), np.int64),)],
    }


def _leaves(tree):
    return mgr_mod._flatten(tree)[1]


@pytest.mark.parametrize("async_save", [False, True])
def test_save_restore_roundtrip(tmp_path, async_save):
    m = CheckpointManager(tmp_path, keep=2, async_save=async_save)
    t = _tree()
    m.save(3, t, extra={"step": 3, "none": None, "list": [1, 2]})
    out, extra = m.restore(template=t)
    assert extra == {"step": 3, "none": None, "list": [1, 2]}
    assert isinstance(out["nested"]["t"], torch.Tensor)
    assert isinstance(out["seq"], list) and isinstance(out["seq"][1], tuple)
    for a, b in zip(_leaves(t), _leaves(out)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_restore_onto_a_torch_template(tmp_path):
    """Numpy leaves saved, torch leaves restored: each goes where its
    template leaf lives, in its dtype."""
    m = CheckpointManager(tmp_path, async_save=False)
    t = _tree(1)
    m.save(0, t)
    template = mgr_mod._unflatten(
        mgr_mod._flatten(t)[2],
        iter([torch.empty(np.shape(x), dtype=torch.float64) for x in _leaves(t)]))
    out, _ = m.restore(template=template)
    for a, b in zip(_leaves(t), _leaves(out)):
        assert isinstance(b, torch.Tensor) and b.dtype == torch.float64
        np.testing.assert_array_equal(np.asarray(a).astype(np.float64), b.numpy())


def test_restore_items_is_keyed_by_path(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(7, _tree(2), extra={"kind": "x"})
    items, extra = m.restore_items()
    assert set(items) == {"a", "nested/b", "nested/t", "seq/0", "seq/1/0"}
    assert extra == {"kind": "x"}
    np.testing.assert_array_equal(items["a"], _tree(2)["a"])


def test_keep_k_gc_and_latest(tmp_path):
    m = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        m.save(s, _tree(s))
    assert m.latest_step() == 4
    assert m._steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_3.done",
                                            "step_4", "step_4.done"]
    items, _ = m.restore_items(3)
    np.testing.assert_array_equal(items["a"], _tree(3)["a"])


def test_async_save_is_committed_after_wait(tmp_path):
    m = CheckpointManager(tmp_path, keep=3, async_save=True)
    m.save(1, _tree())
    m.save(2, _tree(5))                  # waits out the first write
    m.wait()
    assert m._steps() == [1, 2]


def test_torn_checkpoint_ignored_and_pruned(tmp_path):
    m = CheckpointManager(tmp_path, keep=3, async_save=False)
    m.save(1, _tree())
    # a write that died before its marker, and one that died mid-copy
    os.makedirs(tmp_path / "step_2")
    (tmp_path / "step_2" / "meta.json").write_text("garbage")
    os.makedirs(tmp_path / ".tmp_step_3")
    (tmp_path / ".tmp_step_3.done").write_text("ok")
    m2 = CheckpointManager(tmp_path, keep=3)
    assert m2.latest_step() == 1
    assert sorted(os.listdir(tmp_path)) == ["step_1", "step_1.done"]


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore_items()


@pytest.mark.parametrize("bad", [
    {"a": np.zeros((4, 6), np.float32)},                    # missing leaves
    {**_tree(), "a": np.zeros((4, 5), np.float32)},         # wrong shape
])
def test_structure_or_shape_mismatch_rejected(tmp_path, bad):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(1, _tree())
    with pytest.raises(ValueError, match="mismatch"):
        m.restore(template=bad)


def test_restore_requires_template(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(1, _tree())
    with pytest.raises(ValueError, match="template"):
        m.restore()


def test_reference_checkpoint_is_refused(tmp_path):
    from repro.checkpoint import CheckpointManager as RManager

    RManager(str(tmp_path), async_save=False).save(
        0, {"a": np.zeros(3, np.float32)}, block=True)
    with pytest.raises(ValueError, match="repro_torch.checkpoint"):
        CheckpointManager(tmp_path).restore_items()


def test_other_format_version_is_refused(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(0, _tree())
    meta_path = tmp_path / "step_0" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["version"] = mgr_mod.VERSION + 1
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="version"):
        m.restore_items()


def test_bfloat16_leaves_round_trip_bit_for_bit(tmp_path):
    """numpy has no bfloat16: such a leaf is stored as its bits (C5)."""
    gen = torch.Generator().manual_seed(0)
    t = {"w": torch.randn(3, 5, generator=gen).to(torch.bfloat16),
         "mu": torch.randn(3, 5, generator=gen), "step": torch.tensor(4, dtype=torch.int32)}
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(1, t)
    with open(tmp_path / "step_1" / "meta.json") as f:
        assert json.load(f)["dtypes"] == ["float32", "int32", "bfloat16"]
    out, _ = m.restore(template=t)
    for k in t:
        assert out[k].dtype == t[k].dtype and torch.equal(out[k], t[k]), k
    # onto a template of meta tensors (a model's abstract parameters)
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in t.items()}
    out, _ = m.restore(template=meta, device="cpu")
    assert all(out[k].device.type == "cpu" and torch.equal(out[k], t[k]) for k in t)
    items, _ = m.restore_items()
    assert items["w"].dtype == np.float32
    np.testing.assert_array_equal(items["w"], t["w"].float().numpy())


def test_restore_keeps_the_template_key_order(tmp_path):
    """A restored tree walks in its template's order, as the saved one did
    (the optimizer's global norm sums its leaves in that order)."""
    t = {"z": np.ones(2, np.float32), "a": {"y": np.zeros(1), "b": np.ones(1)}}
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(1, t)
    out, _ = m.restore(template=t)
    assert list(out) == ["z", "a"] and list(out["a"]) == ["y", "b"]
