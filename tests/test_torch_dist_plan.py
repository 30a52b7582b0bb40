"""Port vs JAX package: the host plans of the distributed engine and the
pod path, bitwise, on the CPU.

``build_device_shards`` (schemes 1 and 2, with and without weights and
full indices, the scheme-1 ``own_rows``/``gather_map``/``rows_cap``),
``shard_fit_data``, ``pod_lane_order``, ``pod_device_nnz``,
``pod_imbalance``, ``PodPlan.dispatch_batch`` and ``plan_pod`` are host
numpy in both packages and must agree bit for bit.  ``resolve_collectives``
and ``collective_payload_bytes`` are compared on plans built over
stand-in meshes: the reference takes κ from ``mesh.devices.size`` and the
port from ``mesh.size``, so no ``shard_map`` and no process group is
needed.  The pod placement tests of ``tests/serve/test_lane_placement.py``
run against the port's ``prepare_batch`` with stand-in meshes, one per
rank, whose blocks of lanes together make the batch.
"""
import types

import numpy as np
import pytest
import torch

from repro.core import coo as r_coo
from repro.core import distributed as r_dist
from repro.core import layout as r_layout
from repro.core import plan as r_plan
from repro_torch.core import coo as t_coo
from repro_torch.core import distributed as t_dist
from repro_torch.core import layout as t_layout
from repro_torch.core import plan as t_plan
from repro_torch.core.load_balance import Scheme as TScheme
from repro_torch.serve import BatchedEngine

KAPPAS = [1, 2, 4, 8]
SHAPE = (48, 32, 3)          # mode 2 has fewer rows than kappa 4 and 8: scheme 2


def _pair(shape=SHAPE, nnz=1500, seed=5):
    return (r_coo.random_sparse(shape, nnz, seed=seed, distribution="powerlaw"),
            t_coo.random_sparse(shape, nnz, seed=seed, distribution="powerlaw"))


def _weights(nnz, seed=3):
    w = np.random.default_rng(seed).uniform(0.0, 1.0, nnz).astype(np.float32)
    w[::17] = 0.0
    return w


def assert_bitwise(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _ref_mesh(kappa):
    return types.SimpleNamespace(devices=np.empty(kappa, dtype=object),
                                 axis_names=("sm",))


def _port_mesh(kappa):
    return types.SimpleNamespace(size=kappa, rank=0, device=torch.device("cpu"))


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("valued", [False, True], ids=["baked", "valued"])
@pytest.mark.parametrize("scheme", [None, 1, 2], ids=["threshold", "s1", "s2"])
@pytest.mark.parametrize("kappa", KAPPAS)
def test_device_shards_bitwise(kappa, scheme, valued):
    rt, tt = _pair()
    w = _weights(rt.nnz) if valued else None
    schemes = set()
    for d in range(len(SHAPE)):
        rl = r_layout.build_mode_layout(
            rt, d, kappa, scheme=None if scheme is None else r_plan.Scheme(scheme))
        tl = t_layout.build_mode_layout(
            tt, d, kappa, scheme=None if scheme is None else TScheme(scheme))
        kw = dict(weights=w, with_full_indices=valued)
        rs = r_plan.build_device_shards(rl, **kw)
        ts = t_plan.build_device_shards(tl, **kw)
        assert ts.scheme.value == rs.scheme.value
        schemes.add(ts.scheme.value)
        assert (ts.mode, ts.num_rows, ts.nnz_per_dev, ts.input_modes,
                ts.rows_cap) == (rs.mode, rs.num_rows, rs.nnz_per_dev,
                                 rs.input_modes, rs.rows_cap)
        for name in ("idx", "rows", "vals", "row_perm", "idx_full", "ew",
                     "own_rows", "gather_map"):
            assert_bitwise(getattr(ts, name), getattr(rs, name))
    if scheme is None and kappa >= 4:
        assert schemes == {1, 2}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kappa", KAPPAS)
def test_shard_fit_data_bitwise(kappa, weighted):
    rt, tt = _pair()
    w = _weights(rt.nnz) if weighted else None
    ref = r_plan.shard_fit_data(rt, kappa, weights=w)
    got = t_plan.shard_fit_data(tt, kappa, weights=w)
    assert len(got) == len(ref) == (4 if weighted else 3)
    for a, b in zip(got, ref):
        assert_bitwise(a, b)


@pytest.mark.parametrize("method", ["cp", "masked"])
@pytest.mark.parametrize("kappa", [2, 4, 8])
def test_distributed_plan_bitwise(kappa, method):
    rt, tt = _pair()
    kw = dict(weights=_weights(rt.nnz)) if method == "masked" else {}
    ref = r_dist.make_distributed_plan(rt, _ref_mesh(kappa), method=method, **kw)
    got = t_dist.make_distributed_plan(tt, _port_mesh(kappa), method=method, **kw)
    assert got.kappa == ref.kappa == kappa
    for a, b in zip(got.fit_shards, ref.fit_shards):
        assert_bitwise(a, b)
    for ts, rs in zip(got.modes, ref.modes):
        for name in ("idx", "rows", "vals", "row_perm", "idx_full", "ew",
                     "own_rows", "gather_map"):
            assert_bitwise(getattr(ts, name), getattr(rs, name))


@pytest.mark.parametrize("collective", ["psum", "gather"])
@pytest.mark.parametrize("kappa", KAPPAS)
def test_collectives_and_payload_equal(kappa, collective):
    rt, tt = _pair()
    ref = r_dist.make_distributed_plan(rt, _ref_mesh(kappa))
    got = t_dist.make_distributed_plan(tt, _port_mesh(kappa))
    rc = r_dist.resolve_collectives(ref, collective)
    tc = t_dist.resolve_collectives(got, collective)
    assert tc == rc
    for rank in (4, 16):
        assert (t_dist.collective_payload_bytes(got, rank, tc)
                == r_dist.collective_payload_bytes(ref, rank, rc))
    if collective == "gather" and kappa > 1:
        assert (t_dist.collective_payload_bytes(got, 16, tc)
                < t_dist.collective_payload_bytes(got, 16, None))


def test_resolve_collectives_refusals_match():
    rt, tt = _pair()
    w = _weights(rt.nnz)
    ref = r_dist.make_distributed_plan(rt, _ref_mesh(4), method="masked", weights=w)
    got = t_dist.make_distributed_plan(tt, _port_mesh(4), method="masked", weights=w)
    for mod, plan in ((r_dist, ref), (t_dist, got)):
        with pytest.raises(ValueError, match="value-baked"):
            mod.resolve_collectives(plan, "gather")
        with pytest.raises(ValueError, match="unknown collective"):
            mod.resolve_collectives(plan, "allreduce")
        assert mod.resolve_collectives(plan, "psum") is None


# ---------------------------------------------------------------------------
# Pod plans
# ---------------------------------------------------------------------------


def _nnz_draws():
    rng = np.random.default_rng(3)
    draws = []
    for _ in range(40):
        n_dev = int(rng.integers(1, 9))
        per = int(rng.integers(1, 6))
        extra = int(rng.integers(0, 2))          # sometimes not a mesh multiple
        draws.append((rng.integers(0, 10_000, size=n_dev * per + extra).tolist(),
                      n_dev))
    draws += [([100, 90, 80, 70, 40, 30, 20, 10], 4), ([], 4), ([5, 3, 8], 1),
              ([0, 0], 2), ([7] * 6, 3)]
    return draws


@pytest.mark.parametrize("nnz,n_dev", _nnz_draws())
def test_pod_lane_order_and_loads_equal(nnz, n_dev):
    order = t_plan.pod_lane_order(nnz, n_dev)
    assert order == r_plan.pod_lane_order(nnz, n_dev)
    for o in (None, order):
        assert (t_plan.pod_device_nnz(nnz, n_dev, o)
                == r_plan.pod_device_nnz(nnz, n_dev, o))
        if nnz:
            assert (t_plan.pod_imbalance(nnz, n_dev, o)
                    == r_plan.pod_imbalance(nnz, n_dev, o))


@pytest.mark.parametrize("num_devices", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("quantum", [1, 2, 4])
def test_pod_plan_dispatch_equal(num_devices, quantum):
    shape, cap = (18, 13, 9), 512
    rp = r_plan.plan_pod(shape, cap, 3, 2, num_devices=num_devices,
                         batch_quantum=quantum)
    tp = t_plan.plan_pod(shape, cap, 3, 2, num_devices=num_devices,
                         batch_quantum=quantum)
    assert (tp.num_devices, tp.batch_quantum) == (rp.num_devices, rp.batch_quantum)
    assert (tp.bucket.shape, tp.bucket.nnz_cap, tp.bucket.rank, tp.bucket.kappa) == (
        rp.bucket.shape, rp.bucket.nnz_cap, rp.bucket.rank, rp.bucket.kappa)
    for b in range(1, 20):
        assert tp.dispatch_batch(b) == rp.dispatch_batch(b)
    for mod in (t_plan, r_plan):
        with pytest.raises(ValueError, match="batch must be"):
            mod.plan_pod(shape, cap, 3, num_devices=num_devices).dispatch_batch(0)


# ---------------------------------------------------------------------------
# prepare_batch placement (stand-in meshes, host half only)
# ---------------------------------------------------------------------------


def _fake_mesh(n, rank=0):
    return types.SimpleNamespace(axis_names=("batch",), size=n, rank=rank,
                                 device=torch.device("cpu"))


def _prep(engine, tensors, **kw):
    kw.setdefault("n_iters", 3)
    kw.setdefault("tol", -1.0)
    kw.setdefault("seeds", list(range(len(tensors))))
    return engine.prepare_batch(tensors, **kw)


def _preps(tensors, n, **kw):
    placement = kw.pop("lane_placement", "balanced")
    return [_prep(BatchedEngine(3, mesh=_fake_mesh(n, r), backend="segment",
                                lane_placement=placement), tensors, **kw)
            for r in range(n)]


def test_prepare_batch_places_and_inverts():
    from repro.core import random_sparse as r_random_sparse

    rng = np.random.default_rng(0)
    sizes = rng.permutation([300 - 20 * i for i in range(8)]).tolist()
    tensors = [t_coo.random_sparse((10, 9, 8), int(s), seed=i)
               for i, s in enumerate(sizes)]
    preps = _preps(tensors, 4, nnz_cap=320)
    prep = preps[0]
    assert prep.batch == 8 and prep.requested == 8
    assert prep.lane_of is not None
    assert sorted(prep.lane_of) == list(range(8))
    assert all(p.lane_of == prep.lane_of and p.lane_nnz == prep.lane_nnz
               for p in preps)
    for i, t in enumerate(tensors):
        assert prep.lane_nnz[prep.lane_of[i]] == t.nnz
    # the same placement as the reference's engine on the same requests
    r_order = r_plan.pod_lane_order(
        [r_random_sparse((10, 9, 8), int(s), seed=i).nnz
         for i, s in enumerate(sizes)], 4)
    assert [prep.lane_of.index(lane) for lane in range(8)] == r_order
    # each rank holds its own block of 2 lanes; per-lane iteration knobs
    # moved with their tensors
    iters = [3 + i for i in range(8)]
    preps2 = _preps(tensors, 4, nnz_cap=320, n_iters=iters)
    got = np.concatenate([np.asarray(p.max_iters_dev) for p in preps2])
    assert all(p.carry[1].shape == (2,) for p in preps2)
    for i in range(8):
        assert int(got[preps2[0].lane_of[i]]) == iters[i]
    placed = t_plan.pod_imbalance(prep.lane_nnz, 4)
    arrival = t_plan.pod_imbalance([t.nnz for t in tensors], 4)
    assert placed <= arrival + 1e-9


def test_contiguous_engine_keeps_arrival_order():
    tensors = [t_coo.random_sparse((10, 9, 8), 100 + 30 * i, seed=i)
               for i in range(4)]
    prep = _preps(tensors, 4, nnz_cap=256, lane_placement="contiguous")[0]
    assert prep.lane_of is None
    assert prep.lane_nnz == [t.nnz for t in tensors]
    with pytest.raises(ValueError, match="lane_placement"):
        BatchedEngine(3, lane_placement="best-effort", device="cpu")


def test_placement_covers_padding_lanes():
    tensors = [t_coo.random_sparse((10, 9, 8), 60 + 37 * i, seed=i)
               for i in range(6)]
    preps = _preps(tensors, 4, nnz_cap=256)
    prep = preps[0]
    assert prep.requested == 6 and prep.batch == 8
    assert sum(p.carry[1].shape[0] for p in preps) == 8
    if prep.lane_of is not None:
        assert sorted(prep.lane_of) == list(range(8))
        for i, t in enumerate(tensors):
            assert prep.lane_nnz[prep.lane_of[i]] == t.nnz
