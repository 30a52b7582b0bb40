"""Port vs JAX package: the distributed engine over gloo ranks on the CPU.

One group of κ = 4 ranks is spawned for the whole module (gloo, a
``file://`` rendezvous under ``tmp_path``, one thread per rank, a hard
time limit); every rank runs every case and returns its results.  A mesh
of one rank (no process group, identity collectives) runs the same cases
in this process.  The tensor, ``random_sparse((48, 32, 3), 1500, seed=5,
"powerlaw")``, has mode 2 under scheme 2 at κ = 4 (3 rows on 4 ranks), so
one psum truly reduces.

The reference's own distributed path is broken under the installed jax
(``ROADMAP.md`` C-ref1), so the oracle is its single-device ``cpd_als``
on the same seed, at its own distributed tolerances
(``tests/distributed/test_multidevice.py``): fits within 1e-4, factors
within 1e-3.  Inside the port: factors bitwise equal across ranks, one
host read per window plus one, the slab kernel's branch with a mesh (its
plain version here) within 1e-5 of the single-device slab MTTKRP.  The
reference is imported inside the fixtures that use it, so that the
spawned ranks, which import this module, do not load JAX.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import als_device
from repro_torch.core.coo import random_sparse
from repro_torch.core.distributed import (_collect_dist_data,
                                          cpd_als_distributed,
                                          make_distributed_plan,
                                          mttkrp_distributed,
                                          shard_slab_mode_data)
from repro_torch.core.mttkrp import make_plan, mttkrp, mttkrp_dense_ref
from repro_torch.launch import Mesh, make_mesh, spawn_ranks

SHAPE, NNZ, SEED = (48, 32, 3), 1500, 5
R, N_ITERS, CHECK_EVERY, INIT_SEED = 4, 6, 3, 2
CASES = [("cp", "psum"), ("cp", "gather"), ("nncp", "psum"), ("nncp", "gather"),
         ("masked", "psum")]
SPAWN_TIMEOUT = 240.0


def _weights(nnz):
    w = np.random.default_rng(3).uniform(0.0, 1.0, nnz).astype(np.float32)
    w[::19] = 0.0
    return w


def rank_cases(mesh):
    """Every case on this rank: the decompositions, the slab branch's
    MTTKRPs and one window, and the masked gather refusal."""
    t = random_sparse(SHAPE, NNZ, seed=SEED, distribution="powerlaw")
    w = _weights(t.nnz)
    out = {"decomp": {}, "rank": mesh.rank, "size": mesh.size}
    for method, coll in CASES:
        kw = dict(weights=w) if method == "masked" else {}
        plan = make_distributed_plan(t, mesh, method=method, **kw)
        res = cpd_als_distributed(t, R, plan=plan, n_iters=N_ITERS, tol=-1.0,
                                  seed=INIT_SEED, check_every=CHECK_EVERY,
                                  method=method, collective=coll)
        out["decomp"][(method, coll)] = dict(
            fits=res.fits, factors=res.factors, weights=res.weights,
            host_syncs=res.host_syncs, iters=res.iters, engine=res.engine,
            schemes=[m.scheme.value for m in plan.modes])
    masked_plan = make_distributed_plan(t, mesh, method="masked", weights=w)
    try:
        cpd_als_distributed(t, R, plan=masked_plan, n_iters=1, method="masked",
                            collective="gather")
        out["masked_gather"] = None
    except ValueError as e:
        out["masked_gather"] = str(e)

    # The slab kernel's branch with a mesh: this rank's packed shard, then
    # the sum over the mesh.
    plan = make_distributed_plan(t, mesh, device="cpu")
    md, meta = shard_slab_mode_data(plan, R)
    rng = np.random.default_rng(0)
    F = [torch.as_tensor(rng.standard_normal((I, R)).astype(np.float32))
         for I in SHAPE]
    ctx = als_device.make_sweep_context("slab", len(SHAPE), R, SHAPE, meta,
                                        "inv", axis=mesh)
    out["slab_mttkrp"] = [ctx.one_mttkrp(d, md[d], [F], None)[0].numpy()
                          for d in range(len(SHAPE))]
    out["segment_mttkrp"] = [mttkrp_distributed(plan, F, d).numpy()
                             for d in range(len(SHAPE))]
    window = als_device._build_sweep_block("slab", len(SHAPE), R, SHAPE, meta,
                                           "inv", CHECK_EVERY, "cp", mesh)
    _, fit_data = _collect_dist_data(plan)
    state = als_device.init_state(SHAPE, R, INIT_SEED, device="cpu")
    st, fits, ok = window(state, md, fit_data)
    out["slab_window"] = dict(factors=[f.numpy() for f in st[0]],
                              fits=fits.tolist(), ok=bool(ok))
    out["stats"] = dict(mesh.stats)
    return out


@pytest.fixture(scope="module")
def tensors():
    from repro.core import random_sparse as r_random_sparse

    rt = r_random_sparse(SHAPE, NNZ, seed=SEED, distribution="powerlaw")
    tt = random_sparse(SHAPE, NNZ, seed=SEED, distribution="powerlaw")
    return rt, tt


@pytest.fixture(scope="module")
def reference(tensors):
    from repro.core import cpd_als as r_cpd_als

    rt, _ = tensors
    w = _weights(rt.nnz)
    return {m: r_cpd_als(rt, R, n_iters=N_ITERS, tol=-1.0, seed=INIT_SEED,
                         method=m, **({"weights": w} if m == "masked" else {}))
            for m in ("cp", "nncp", "masked")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{kappa: [per-rank results]}: κ = 4 spawned over gloo, κ = 1 here."""
    one = rank_cases(make_mesh((1,), ("sm",), device="cpu"))
    four = spawn_ranks(rank_cases, 4, timeout=SPAWN_TIMEOUT, device="cpu",
                       workdir=tmp_path_factory.mktemp("dist_ranks"))
    return {1: [one], 4: four}


@pytest.mark.parametrize("kappa", [1, 4])
@pytest.mark.parametrize("method,collective", CASES)
def test_distributed_matches_single_device_reference(ranks, reference, kappa,
                                                     method, collective):
    got = ranks[kappa][0]["decomp"][(method, collective)]
    ref = reference[method]
    assert got["engine"] == "distributed" and got["iters"] == ref.iters
    np.testing.assert_allclose(got["fits"], ref.fits, rtol=1e-4, atol=1e-4)
    for Fd, Fr in zip(got["factors"], ref.factors):
        np.testing.assert_allclose(Fd, Fr, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("method,collective", CASES)
def test_factors_bitwise_across_ranks(ranks, method, collective):
    per_rank = [r["decomp"][(method, collective)] for r in ranks[4]]
    assert [r["rank"] for r in ranks[4]] == [0, 1, 2, 3]
    assert per_rank[0]["schemes"] == [1, 1, 2]
    for other in per_rank[1:]:
        assert other["fits"] == per_rank[0]["fits"]
        assert np.array_equal(other["weights"], per_rank[0]["weights"])
        for a, b in zip(other["factors"], per_rank[0]["factors"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("kappa", [1, 4])
@pytest.mark.parametrize("method,collective", CASES)
def test_one_host_read_per_window(ranks, kappa, method, collective):
    for r in ranks[kappa]:
        syncs = r["decomp"][(method, collective)]["host_syncs"]
        assert syncs <= N_ITERS // CHECK_EVERY + 1


@pytest.mark.parametrize("kappa", [1, 4])
def test_gather_matches_psum(ranks, kappa):
    for method in ("cp", "nncp"):
        a = ranks[kappa][0]["decomp"][(method, "psum")]
        b = ranks[kappa][0]["decomp"][(method, "gather")]
        np.testing.assert_allclose(a["fits"], b["fits"], rtol=1e-5, atol=1e-5)
        for Fa, Fb in zip(a["factors"], b["factors"]):
            np.testing.assert_allclose(Fa, Fb, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kappa", [1, 4])
def test_gather_on_masked_plan_raises(ranks, kappa):
    for r in ranks[kappa]:
        assert r["masked_gather"] is not None
        assert "value-baked" in r["masked_gather"]


@pytest.mark.parametrize("mode", range(len(SHAPE)))
@pytest.mark.parametrize("kappa", [1, 4])
def test_slab_branch_with_mesh_matches_single_device(ranks, tensors, kappa, mode):
    _, tt = tensors
    rng = np.random.default_rng(0)
    F = [torch.as_tensor(rng.standard_normal((I, R)).astype(np.float32))
         for I in SHAPE]
    single = mttkrp(make_plan(tt, 1, device="cpu"), F, mode, backend="slab")
    scale = float(single.abs().sum())
    dense = mttkrp_dense_ref(tt, [f.numpy() for f in F], mode)
    for r in ranks[kappa]:
        err = float(np.abs(r["slab_mttkrp"][mode] - single.numpy()).max())
        assert err <= 1e-5 * scale
        np.testing.assert_allclose(r["segment_mttkrp"][mode], dense,
                                   rtol=1e-4, atol=1e-3)
        assert np.array_equal(r["slab_mttkrp"][mode], ranks[kappa][0]["slab_mttkrp"][mode])


@pytest.mark.parametrize("kappa", [1, 4])
def test_slab_window_with_mesh_matches_single_device(ranks, tensors, kappa):
    _, tt = tensors
    plan = make_plan(tt, 1, device="cpu")
    mode_data, meta = als_device._collect_mode_data(plan, "slab", R)
    window = als_device._build_sweep_block("slab", len(SHAPE), R, SHAPE, meta,
                                           "inv", CHECK_EVERY)
    state = als_device.init_state(SHAPE, R, INIT_SEED, device="cpu")
    st, fits, ok = window(state, mode_data, als_device.make_fit_data(tt, "cpu"))
    for r in ranks[kappa]:
        got = r["slab_window"]
        assert got["ok"] and bool(ok)
        np.testing.assert_allclose(got["fits"], fits.tolist(), rtol=1e-5, atol=1e-5)
        for a, b in zip(got["factors"], st[0]):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=1e-4)


def test_gloo_ranks_ran_their_collectives_on_the_host(ranks):
    for r in ranks[4]:
        assert r["size"] == 4 and r["stats"]["collectives"] > 0
        assert r["stats"]["staged_copies"] == 0      # CPU tensors: nothing staged
    assert ranks[1][0]["stats"]["collectives"] == 0  # one rank: identity


# ---------------------------------------------------------------------------
# In-process checks (no ranks)
# ---------------------------------------------------------------------------


def test_build_sweep_fn_argument_checks():
    mesh = make_mesh((1,), ("sm",), device="cpu")
    with pytest.raises(ValueError, match="distributed segment"):
        als_device.build_sweep_fn("segment", 3, R, SHAPE, None, "inv",
                                  collectives=("psum",) * 3)
    with pytest.raises(ValueError, match="distributed segment"):
        als_device.build_sweep_fn("slab", 3, R, SHAPE, None, "inv", axis=mesh,
                                  collectives=("psum",) * 3)
    with pytest.raises(ValueError, match="bad collectives"):
        als_device.build_sweep_fn("segment", 3, R, SHAPE, None, "inv",
                                  axis=mesh, collectives=("psum", "all"))
    with pytest.raises(NotImplementedError, match="segment backend"):
        als_device.build_sweep_fn("slab", 3, R, SHAPE, None, "inv",
                                  method="masked", axis=mesh)


def test_distributed_front_door_refusals(tensors):
    _, tt = tensors
    mesh = make_mesh((1,), ("sm",), device="cpu")
    plan = make_distributed_plan(tt, mesh)
    with pytest.raises(ValueError, match="built for method"):
        cpd_als_distributed(tt, R, plan=plan, method="nncp")
    with pytest.raises(ValueError, match="weight"):
        make_distributed_plan(tt, mesh, weights=np.ones(tt.nnz, np.float32))
    with pytest.raises(ValueError, match="unknown collective"):
        cpd_als_distributed(tt, R, plan=plan, collective="ring")


def test_mesh_of_one_rank():
    mesh = make_mesh((1,), ("sm",), device="cpu")
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh.psum(x) is x
    assert mesh.all_gather(x).shape == (1, 2, 3)
    assert mesh.ranks == [0] and mesh.group is None
    with pytest.raises(ValueError, match="process group"):
        make_mesh((2,), ("sm",), device="cpu")
    with pytest.raises(NotImplementedError, match="1-D"):
        make_mesh((2, 2), ("a", "b"), device="cpu")
    with pytest.raises(ValueError, match="process group"):
        Mesh("sm", size=2, rank=0, device="cpu")


def sleeping_rank(mesh, seconds):
    time.sleep(seconds)
    return mesh.rank


def failing_rank(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    mesh.barrier()           # rank 0 would wait here forever
    return mesh.rank


def test_spawn_time_limit_kills_the_ranks(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        spawn_ranks(sleeping_rank, 1, (600,), timeout=8.0, device="cpu",
                    workdir=tmp_path)
    assert time.monotonic() - t0 < 60


def test_spawn_rank_error_ends_every_rank(tmp_path):
    """The first rank to exit with an error is reported: rank 1's own
    error, or rank 0's barrier broken by rank 1's exit, whichever the
    parent sees first; either way no rank is left waiting."""
    from torch.multiprocessing import ProcessRaisedException

    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException):
        spawn_ranks(failing_rank, 2, timeout=SPAWN_TIMEOUT, device="cpu",
                    workdir=tmp_path)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT
