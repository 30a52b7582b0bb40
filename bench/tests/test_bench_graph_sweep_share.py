"""graph_sweep_share on made-up runs: the replayed sweeps over all the
window's sweeps, nothing without calls, nothing from a program whose
results lack the counter."""
import types

from bench.harness.spec import metric_reader


def _run(*results, ok=True):
    calls = [types.SimpleNamespace(ok=ok, result=r) for r in results]
    return types.SimpleNamespace(calls=calls)


def _result(iters, graph_sweeps=None):
    r = types.SimpleNamespace(iters=iters)
    if graph_sweeps is not None:
        r.graph_sweeps = graph_sweeps
    return r


def test_share_of_replayed_sweeps():
    read = metric_reader("graph_sweep_share")
    assert read(_run(_result(25, 25), _result(25, 20))) == 45 / 50
    assert read(_run(_result(25, 0))) == 0.0


def test_nothing_to_read():
    read = metric_reader("graph_sweep_share")
    assert read(_run()) is None
    assert read(_run(_result(25, 25), ok=False)) is None
    assert read(_run(_result(25), _result(25))) is None
    assert read(_run(_result(25, 25), _result(25))) is None
