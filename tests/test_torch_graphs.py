"""The fused engine's two ways of issuing a sweep, on the CPU.

``als_device.uses_graphs`` decides, from what a call can observe, whether
its sweeps replay captured CUDA graphs: only on a card, with a plan the
caller holds, for cp and nncp.  On the CPU every call is
eager and reports ``graph_sweeps == 0``.  The graph path's bookkeeping
(the static state, the ring of fits, the solve flag, the eager rescue, a
second call's fresh start) is held to the eager path here with a
stand-in for ``torch.cuda.CUDAGraph`` that re-runs the captured steps at
each replay; the card tests (``test_torch_cuda.py``) replay real graphs.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import als_device
from repro_torch.core.coo import random_sparse
from repro_torch.core.mttkrp import make_plan

CUDA = torch.device("cuda")


@pytest.mark.parametrize("device,caller_plan,method,expected", [
    (CUDA, True, "cp", True),
    (CUDA, True, "nncp", True),
    (torch.device("cuda", 1), True, "cp", True),
    (torch.device("cpu"), True, "cp", False),
    (torch.device("cpu"), True, "nncp", False),
    (torch.device("cpu"), False, "cp", False),
    (CUDA, False, "cp", False),
    (CUDA, False, "nncp", False),
    (CUDA, True, "masked", False),
])
def test_graphs_only_on_a_card_with_the_callers_plan_and_no_host_read(
        device, caller_plan, method, expected):
    assert als_device.uses_graphs(device, caller_plan, method) is expected


@pytest.mark.parametrize("method", ["cp", "nncp", "masked"])
@pytest.mark.parametrize("with_plan", [False, True])
def test_cpu_calls_replay_nothing(method, with_plan):
    t = random_sparse((20, 9, 14), 400, seed=3, distribution="powerlaw")
    kw = dict(n_iters=4, check_every=2, tol=-1.0, method=method, device="cpu")
    if method == "masked":
        kw["weights"] = np.random.default_rng(4).uniform(0.2, 1.0, t.nnz)
    plan = make_plan(t, 1, device="cpu") if with_plan else None
    for _ in range(2):
        res = als_device.cpd_als_fused(t, 4, plan=plan, **kw)
        assert res.graph_sweeps == 0 and res.iters == 4
    assert plan is None or plan._graphs == {}


class _StandInGraph:
    """Runs the captured function once at capture, like a first replay,
    and again at each replay, copying what it returns into what the
    capture returned (a real graph writes the same buffers)."""

    captures = 0

    def __init__(self, pool):
        pass

    def capture(self, fn, *args):
        _StandInGraph.captures += 1
        self.fn, self.args = fn, args
        self.out = fn(*args)
        return self.out

    def replay(self):
        new = self.fn(*self.args)
        for a, b in zip(self.out or (), new or ()):
            a.copy_(b)


@pytest.fixture
def stand_in_graphs(monkeypatch):
    monkeypatch.setattr(als_device, "_Graph", _StandInGraph)
    monkeypatch.setattr(als_device, "graph_pool_bytes", lambda pool, dev: 0)
    monkeypatch.setattr(_StandInGraph, "captures", 0)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None,
                        raising=False)
    rule = als_device.uses_graphs
    monkeypatch.setattr(als_device, "uses_graphs",
                        lambda device, *a: rule(CUDA, *a))


def _same(a, b):
    np.testing.assert_array_equal(a.fits, b.fits)
    np.testing.assert_array_equal(a.weights, b.weights)
    for x, y in zip(a.factors, b.factors):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("method,backend", [
    ("cp", "slab"), ("cp", "segment"), ("nncp", "slab")])
def test_replayed_calls_equal_eager_calls(stand_in_graphs, method, backend):
    """The first call on the plan runs eagerly and captures; the next two,
    from other starts, replay: each equals its eager call (no plan),
    bitwise here, with the same host reads; the second is not the first
    continued (static buffers refreshed, fits copied out)."""
    t = random_sparse((40, 7, 33, 5), 1500, seed=0, distribution="powerlaw")
    plan = make_plan(t, 1, device="cpu")
    kw = dict(n_iters=7, check_every=3, tol=-1.0, method=method,
              backend=backend, solver="cho", device="cpu")
    first = als_device.cpd_als_fused(t, 5, plan=plan, seed=1, **kw)
    assert first.graph_sweeps == 0 and len(plan._graphs) == 1
    for seed in (2, 3):
        eager = als_device.cpd_als_fused(t, 5, seed=seed, **kw)
        replayed = als_device.cpd_als_fused(t, 5, plan=plan, seed=seed, **kw)
        assert replayed.graph_sweeps == replayed.iters == 7
        assert replayed.host_syncs == eager.host_syncs
        _same(replayed, eager)
    assert len(plan._graphs) == 1


def test_failed_window_reruns_eagerly_from_its_start(stand_in_graphs):
    """A gram that is not positive definite fails the first window's
    Cholesky: that window reruns eagerly with the rescue (one more host
    read, its sweeps not counted as replayed), the rest replay."""
    t = random_sparse((40, 7, 33, 5), 1500, seed=0, distribution="powerlaw")
    plan = make_plan(t, 1, device="cpu")
    factors, grams, weights = als_device.init_state_host(t.shape, 5, 3)
    grams = list(grams)
    grams[1] = -np.eye(5, dtype=np.float32)
    start = (factors, tuple(grams), weights)
    kw = dict(n_iters=6, check_every=3, tol=-1.0, solver="cho", device="cpu")
    als_device.cpd_als_fused(t, 5, plan=plan, **kw)
    eager = als_device.cpd_als_fused(t, 5, init_state=start, **kw)
    replayed = als_device.cpd_als_fused(t, 5, plan=plan, init_state=start, **kw)
    assert eager.host_syncs == replayed.host_syncs == 4
    assert replayed.graph_sweeps == 3
    _same(replayed, eager)


def test_a_longer_window_grows_the_fit_ring(stand_in_graphs):
    """The graphs are captured once per plan, whatever the window length:
    a later call with longer windows captures only the fit's graph again,
    for a longer ring of fits, and equals its eager call; shorter windows
    use the ring as it is."""
    t = random_sparse((40, 7, 33, 5), 1500, seed=0, distribution="powerlaw")
    plan = make_plan(t, 1, device="cpu")
    kw = dict(tol=-1.0, solver="cho", device="cpu")
    als_device.cpd_als_fused(t, 5, plan=plan, n_iters=4, check_every=2, **kw)
    (graphs,) = plan._graphs.values()
    assert graphs.fits.numel() == 2
    assert _StandInGraph.captures == 2 * t.nmodes + 1
    for n_iters, every, ring, captures in ((7, 3, 3, 2 * t.nmodes + 2),
                                           (5, 1, 3, 2 * t.nmodes + 2)):
        eager = als_device.cpd_als_fused(t, 5, seed=4, n_iters=n_iters,
                                         check_every=every, **kw)
        replayed = als_device.cpd_als_fused(t, 5, plan=plan, seed=4,
                                            n_iters=n_iters, check_every=every,
                                            **kw)
        assert replayed.graph_sweeps == n_iters
        assert (graphs.fits.numel(), _StandInGraph.captures) == (ring, captures)
        _same(replayed, eager)
    assert list(plan._graphs.values()) == [graphs]
