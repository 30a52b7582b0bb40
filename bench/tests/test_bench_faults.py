"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card, plants one fault in the program the
window drives and runs the rest of a run on the CPU at a tiny size.  The
faults this cell can have: a sweep that returns its state unchanged;
half of the nonzeros left out of the MTTKRP, the rest counted double (the
mean over the rest); an answer altered where it is produced.  The cell
runs on one card, so no exchange between cards can be left out.
"""
import numpy as np
import pytest

from bench.harness import cell as cell_mod
from bench.tests.tiny import tiny_cell
from repro_torch.core import als_device

SEED = 2 ** 31 + 99


@pytest.fixture(autouse=True)
def fresh_window_functions():
    """Window functions are cached per shape: drop those built with a
    fault, before and after."""
    als_device._build_sweep_block.cache_clear()
    yield
    als_device._build_sweep_block.cache_clear()


def run():
    return cell_mod.run_cell(tiny_cell(), SEED, 0.3, False, device="cpu",
                             require_cards=False)


def test_sound_run_is_correct():
    assert run()["correct"] is True


def test_state_returned_unchanged(monkeypatch):
    sound = als_device.build_sweep_fn

    def broken(*args, **kwargs):
        sweep = sound(*args, **kwargs)

        def unchanged(state, mode_data_all, fit_data, rescue=False):
            _, fit, ok = sweep(state, mode_data_all, fit_data, rescue)
            return state, fit, ok
        return unchanged

    monkeypatch.setattr(als_device, "build_sweep_fn", broken)
    line = run()
    assert line["correct"] is False
    assert line["checks"]["factor_gap"]["value"] > 0.1


def test_half_the_nonzeros_left_out(monkeypatch):
    sound = als_device.slab_backend

    def broken(mode_data, factors, num_rows, meta):
        idxp, valsp, *rest = mode_data
        half = valsp.clone()
        half[..., 1::2] = 0.0
        half[..., ::2] *= 2.0
        return sound((idxp, half, *rest), factors, num_rows, meta)

    monkeypatch.setattr(als_device, "slab_backend", broken)
    line = run()
    assert line["correct"] is False


def test_answer_altered_where_produced(monkeypatch):
    sound = als_device.cpd_als_fused

    def broken(*args, **kwargs):
        result = sound(*args, **kwargs)
        result.factors[0][0] = -np.asarray(result.factors[0][0])
        return result

    monkeypatch.setattr(als_device, "cpd_als_fused", broken)
    line = run()
    assert line["correct"] is False
    assert line["checks"]["fit_gap"]["value"] <= line["checks"]["fit_gap"]["limit"]
