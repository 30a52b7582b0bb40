"""The spans inside the port's CP-ALS call and its upload counter, on the
CPU.

A fused call through the front door opens ``cpd.call`` and inside it
``cpd.prepare``, one ``als.window`` per check window (each holding, per
sweep, ``als.mttkrp`` and ``als.update`` for every mode in order and one
``als.fit``) and ``cpd.finish``; planning opens ``plan.layouts``, one
``plan.sort`` inside it per mode copy ordered, and one ``plan.pack`` per
mode packed.  ``CPDResult.h2d_bytes`` is the summed
size of the arrays the call uploaded.  Under ``torch.profiler`` the same
spans are profiler records with the same nesting, whether or not a
Tracer is installed.
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import als_device
from repro_torch.core.coo import random_sparse
from repro_torch.core.cpd import cpd_als
from repro_torch.core.mttkrp import make_plan
from repro_torch.obs import trace

RANK = 3
CALL_SPANS = {"cpd.call", "cpd.prepare", "als.window", "als.mttkrp",
              "als.update", "als.fit", "cpd.finish", "plan.layouts",
              "plan.sort", "plan.pack"}


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    trace.disable()


def _packed_plan(t):
    plan = make_plan(t, 1, device="cpu")
    for d in range(t.nmodes):
        plan.packed(d)
    return plan


def _spans(tr):
    return sorted((r for r in tr.records() if r["kind"] == "span"),
                  key=lambda r: r["ts_us"])


def _children(spans, parent):
    return [r for r in spans if r["parent"] == parent["id"]]


@pytest.mark.parametrize("shape,nnz", [((16, 12, 9), 400),
                                       ((10, 8, 7, 6), 500)])
@pytest.mark.parametrize("check_every", [1, 3])
def test_span_tree_of_a_fused_call(shape, nnz, check_every):
    t = random_sparse(shape, nnz, seed=3)
    plan = _packed_plan(t)
    n_iters, N = 4, len(shape)
    with trace.capture() as tr:
        res = cpd_als(t, RANK, plan=plan, n_iters=n_iters,
                      check_every=check_every, tol=-1.0, device="cpu")
    spans = _spans(tr)
    roots = [r for r in spans if r["parent"] is None]
    assert [r["name"] for r in roots] == ["cpd.call"]
    call = roots[0]
    assert call["args"] == {"engine": "fused", "method": "cp",
                            "backend": "slab", "n_iters": n_iters,
                            "check_every": check_every}
    windows = -(-n_iters // check_every)
    kids = _children(spans, call)
    assert [r["name"] for r in kids] == (
        ["cpd.prepare"] + ["als.window"] * windows + ["cpd.finish"])
    assert _children(spans, kids[0]) == []          # the plan was packed
    assert kids[0]["args"] == {"h2d_bytes": res.h2d_bytes}
    assert _children(spans, kids[-1]) == []
    sweep = [x for d in range(N)
             for x in (("als.mttkrp", d), ("als.update", d))]
    sweep.append(("als.fit", None))
    for w in kids[1:-1]:
        got = [(r["name"], r["args"].get("mode"))
               for r in _children(spans, w)]
        assert got == sweep * w["args"]["sweeps"]
        assert all(r["args"]["lanes"] == 1 for r in _children(spans, w)
                   if r["name"] == "als.mttkrp")
    assert sum(w["args"]["sweeps"] for w in kids[1:-1]) == res.iters


def test_plan_spans_pack_once_per_mode():
    t = random_sparse((16, 12, 9, 5), 400, seed=4)
    with trace.capture() as tr:
        plan = make_plan(t, 1, device="cpu")
        for _ in range(2):
            for d in range(t.nmodes):
                plan.packed(d)
    spans = _spans(tr)
    assert [r["name"] for r in spans] == (
        ["plan.layouts"] + ["plan.sort"] * 4 + ["plan.pack"] * 4)
    assert [r["args"]["mode"] for r in spans[1:]] == [0, 1, 2, 3] * 2
    assert [r["name"] for r in _children(spans, spans[0])] == ["plan.sort"] * 4
    # A call that plans for itself does it inside its preparation.
    with trace.capture() as tr:
        cpd_als(t, RANK, n_iters=1, tol=-1.0, device="cpu")
    spans = _spans(tr)
    prep = next(r for r in spans if r["name"] == "cpd.prepare")
    assert [r["name"] for r in _children(spans, prep)] == (
        ["plan.layouts"] + ["plan.pack"] * 4)


def _state_bytes(host_state):
    factors, grams, weights = host_state
    return sum(np.asarray(a, np.float32).nbytes
               for a in (*factors, *grams, weights))


@pytest.mark.parametrize("case", ["cp", "masked", "coo_without_plan"])
def test_h2d_bytes_is_the_uploaded_arrays_nbytes(case):
    t = random_sparse((16, 12, 9), 400, seed=5)
    host_state = als_device.init_state_host(t.shape, RANK, seed=1)
    idx, vals = t.indices, t.values.astype(np.float32)
    norm = np.float32(0).nbytes
    if case == "cp":
        res = cpd_als(t, RANK, plan=_packed_plan(t), n_iters=2, tol=-1.0,
                      init_state=host_state, device="cpu")
        fit = idx.nbytes + vals.nbytes + norm
    elif case == "masked":
        w = np.random.default_rng(0).uniform(size=t.nnz).astype(np.float32)
        res = cpd_als(t, RANK, plan=_packed_plan(t), n_iters=2, tol=-1.0,
                      method="masked", weights=w, init_state=host_state,
                      device="cpu")
        fit = idx.nbytes + vals.nbytes + w.nbytes + norm
    else:
        res = cpd_als(t, RANK, backend="coo", n_iters=2, tol=-1.0,
                      init_state=host_state, device="cpu")
        fit = 2 * (idx.nbytes + vals.nbytes) + norm    # COO arrays, fit data
    assert res.h2d_bytes == _state_bytes(host_state) + fit
    assert cpd_als(t, RANK, n_iters=1, engine="host",
                   device="cpu").h2d_bytes == 0


def _profiled_tree(events):
    """(name, enclosing span's name) of each span record, in start order."""
    out = []
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.name not in CALL_SPANS:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in CALL_SPANS:
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


@pytest.mark.parametrize("with_tracer", [False, True])
def test_profiler_sees_the_spans_with_the_same_nesting(with_tracer):
    t = random_sparse((10, 8, 7, 6), 300, seed=6)
    plan = _packed_plan(t)
    with trace.capture() as tr:
        cpd_als(t, RANK, plan=plan, n_iters=3, check_every=2, tol=-1.0,
                device="cpu")
    names = {r["id"]: r["name"] for r in tr.records()}
    expected = [(r["name"], names.get(r["parent"])) for r in _spans(tr)]
    if not with_tracer:
        assert trace.active() is None
    with trace.capture() if with_tracer else contextlib.nullcontext() as tr2:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            cpd_als(t, RANK, plan=plan, n_iters=3, check_every=2, tol=-1.0,
                    device="cpu")
    assert _profiled_tree(prof.events()) == expected
    if with_tracer:
        names2 = {r["id"]: r["name"] for r in tr2.records()}
        assert [(r["name"], names2.get(r["parent"]))
                for r in _spans(tr2)] == expected


def test_sink_follows_the_tracer_and_the_profiler():
    assert trace.sink() is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.sink() is trace.PROFILER
        with trace.capture() as tr:
            assert trace.sink() is tr
        with trace.span("x", k=1) as sp:
            assert sp.set(k=2) is sp            # attrs go nowhere
    assert trace.sink() is None
    assert trace.span("x") is trace.NULL
    assert torch.autograd._profiler_enabled() is False
