"""The refusals: JAX or the JAX package loaded, no card."""
import pytest

from bench.harness import guard


def test_forbidden_top_level_names_compared_whole():
    assert guard.forbidden_modules(["jax", "jax.numpy"]) == ["jax"]
    assert guard.forbidden_modules(["repro", "repro.core.cpd"]) == ["repro"]
    assert guard.forbidden_modules(["flax.linen", "jaxlib.xla"]) == [
        "flax", "jaxlib"]
    assert guard.forbidden_modules(
        ["repro_torch", "repro_torch.core.cpd", "jaxtyping", "reprolib",
         "torch"]) == []


def test_this_process_loaded_nothing_forbidden():
    import bench.harness.cell  # noqa: F401  (the harness and the port)
    import repro_torch.core.cpd  # noqa: F401

    assert guard.forbidden_modules() == []


def test_no_card_is_refused(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        guard.require_cards(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="asks for 4"):
        guard.require_cards(4)
