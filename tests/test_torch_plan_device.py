"""Planning where the plan lives: the mode copies' ordering and the slab
packing as torch operations on the plan's device, held on the CPU to the
JAX package's host layouts and packing, bit for bit.

``make_plan(device=...)`` uploads the COO once, sorts each mode copy with
one stable sort of its key (the ordering waits on the host until its
mode is packed), packs each mode by gathering every slot
straight from the canonical COO through the copy's ordering, and keeps
the packed arrays as the device data (no second upload).  The host arrays
other paths read (``layouts[d].indices``, ``.perm``, ``packed(d)``'s
arrays) are made when first read.  A small stand-in shaped like FROSTT
enron (one mode much longer than the rest) runs through ``cpd_als`` and
matches the benchmark's plain reference.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import coo as r_coo
from repro.core import layout as r_layout
from repro.core import plan as r_plan
from repro.kernels import ops as r_ops
from repro_torch.core import als_device
from repro_torch.core.coo import SparseTensor, random_sparse
from repro_torch.core.cpd import cpd_als
from repro_torch.core.mttkrp import make_plan
from repro_torch.kernels import ops as t_ops
from repro_torch.obs import trace

LAYOUT_FIELDS = ("indices", "rows", "values", "perm", "part_offsets",
                 "row_perm", "row_lo", "row_hi", "row_ptr")
PACK_FIELDS = ("rb_of", "first", "idx_packed", "vals_packed", "lrows_packed",
               "val_scatter")
# 3, 4 and 5 modes; a one-row mode; a 300-row mode with 120 nonzeros,
# whose row blocks of 8 are mostly empty.
SHAPES = [((16, 12, 9), 400), ((40, 1, 33, 5), 600),
          ((9, 6, 5, 4, 3), 300), ((300, 7, 5), 120)]


def assert_bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def assert_packs_equal(a, b):
    for field in PACK_FIELDS:
        assert_bitwise(getattr(a, field), getattr(b, field))
    assert_bitwise(a.weighted_vals(), b.weighted_vals())
    assert (a.num_row_blocks, a.num_real_slabs, tuple(a.input_modes),
            a.pad_fraction) == (b.num_row_blocks, b.num_real_slabs,
                                tuple(b.input_modes), b.pad_fraction)


@pytest.mark.parametrize("shape,nnz", SHAPES)
@pytest.mark.parametrize("kappa", [1, 3, 64])
@pytest.mark.parametrize("seed", [0, 17])
def test_plan_on_device_matches_reference_host_plan(shape, nnz, kappa, seed):
    """Every copy and every packing of ``make_plan(device="cpu")``,
    scheme 2 where kappa exceeds a mode's length, capped and weighted
    packings through the same ordering."""
    t = r_coo.random_sparse(shape, nnz, seed=seed, distribution="powerlaw")
    w = np.random.default_rng(seed).random(t.nnz).astype(np.float32)
    tplan = make_plan(t, kappa, block_rows=8, tile=16, device="cpu")
    for d, a_lay in enumerate(r_layout.build_all_mode_layouts(t, kappa)):
        a = r_ops.pack_layout(a_lay, block_rows=8, tile=16)
        assert_packs_equal(a, tplan.packed(d))
        b_lay = tplan.layouts[d]
        assert a_lay.scheme.value == b_lay.scheme.value
        for field in LAYOUT_FIELDS:
            assert_bitwise(getattr(a_lay, field), getattr(b_lay, field))
        cap = r_plan.slab_cap(a_lay.num_rows, t.nnz + 300, 8, 16)
        for weights in (None, w):
            a = r_ops.pack_layout(a_lay, block_rows=8, tile=16,
                                  num_slabs_cap=cap, weights=weights)
            b = t_ops.pack_layout(b_lay, block_rows=8, tile=16,
                                  num_slabs_cap=cap, weights=weights)
            assert b.num_slabs == cap
            assert_packs_equal(a, b)
    schemes = {lay.scheme.value for lay in tplan.layouts}
    assert schemes == ({1} if kappa == 1 else schemes)
    if kappa == 64:     # every shape has a mode shorter than 64
        assert 2 in schemes


@pytest.mark.parametrize("assignment", ["greedy", "cyclic"])
@pytest.mark.parametrize("kappa", [2, 5])
def test_plan_assignments_match_reference(assignment, kappa):
    t = r_coo.random_sparse((40, 7, 33, 5), 900, seed=3,
                            distribution="powerlaw")
    tplan = make_plan(t, kappa, assignment=assignment, device="cpu")
    for d, a_lay in enumerate(r_layout.build_all_mode_layouts(
            t, kappa, assignment=assignment)):
        for field in LAYOUT_FIELDS:
            assert_bitwise(getattr(a_lay, field),
                           getattr(tplan.layouts[d], field))
        assert_packs_equal(r_ops.pack_layout(a_lay), tplan.packed(d))


@pytest.mark.parametrize("block_rows,tile", [(8, 16), (128, 256)])
def test_pack_slabs_of_tensors_equals_numpy(block_rows, tile):
    """``pack_slabs`` packs tensors where they lie and numpy arrays on
    the CPU, with the same bytes."""
    t = random_sparse((50, 20, 10), 800, seed=5, distribution="powerlaw")
    lay = make_plan(t, 1, device="cpu").layouts[0]
    args = (lay.indices[:, 1:], lay.rows, lay.values)
    a = t_ops.pack_slabs(*args, lay.num_rows, block_rows=block_rows,
                         tile=tile)
    b = t_ops.pack_slabs(*(torch.as_tensor(x) for x in args), lay.num_rows,
                         block_rows=block_rows, tile=tile)
    assert_packs_equal(a, b)
    with pytest.raises(ValueError, match="sorted"):
        t_ops.pack_slabs(args[0], args[1][::-1].copy(), args[2],
                         lay.num_rows)


def test_empty_tensor_packs_one_padding_slab_per_block():
    t = SparseTensor(np.zeros((0, 3), np.int32), np.zeros(0, np.float32),
                     (20, 4, 3))
    plan = make_plan(t, 1, block_rows=8, tile=16, device="cpu")
    p = plan.packed(0)
    assert p.num_slabs == 3 and p.pad_fraction == 1.0
    assert not p.idx_packed.any() and not p.vals_packed.any()
    assert p.val_scatter.shape == (0,) and p.val_scatter.dtype == np.int32


def test_device_data_is_the_packing_and_the_coo_is_dropped():
    """``device_packed`` hands over the packing's own tensors; the upload
    of the COO is dropped once every mode is packed, the copies' orderings
    wait on the host, and ``device_bytes`` counts what stays."""
    t = random_sparse((30, 20, 10, 6), 700, seed=8, distribution="powerlaw")
    plan = make_plan(t, 1, device="cpu")
    assert plan._source is not None
    datas = [plan.device_packed(d) for d in range(t.nmodes)]
    assert plan._source is None
    expected = 0
    for d, data in enumerate(datas):
        p = plan.packed(d)
        for name, got in zip(("idx_packed", "vals_packed", "lrows_packed",
                              "rb_of"), data[:4]):
            assert got.data_ptr() == p.slots[name].data_ptr()
        assert plan.layouts[d].order.device.type == "cpu"
        chunks = data[4]
        expected += sum(x.nbytes for x in p.slots.values()) + data[5].nbytes + sum(
            x.nbytes for x in (chunks.chunk_slab, chunks.rb_chunk_ptr,
                               chunks.group_chunk, chunks.rb_group_ptr))
    assert plan.device_bytes == expected


def test_host_arrays_are_made_when_read():
    t = random_sparse((30, 20, 10), 500, seed=9, distribution="powerlaw")
    plan = make_plan(t, 2, device="cpu")
    lay = plan.layouts[1]
    plan.device_packed(1)
    assert "indices" not in lay._host
    assert_bitwise(lay.indices, t.indices[lay.perm])
    assert "indices" in lay._host
    assert lay.nbytes() == (lay.indices.nbytes + lay.values.nbytes
                            + lay.rows.nbytes)


def test_staged_fit_data_is_the_fit_data():
    """The fit data uploaded from a plan's staged host copy (page-locked
    on a card; plain tensors here) is bitwise the pageable upload, and a
    plan off a card stages nothing."""
    t = random_sparse((30, 20, 10), 500, seed=10, distribution="powerlaw")
    assert make_plan(t, 1, device="cpu").staged_fit_data() is None
    staged = (torch.from_numpy(t.indices),
              torch.from_numpy(t.values.astype(np.float32)), t.norm() ** 2)
    a = als_device.make_fit_data(t, "cpu")
    b = als_device.make_fit_data(t, "cpu", staged)
    for x, y in zip(a[0] + a[1:], b[0] + b[1:]):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_plan_sort_spans_one_per_mode_inside_the_layouts():
    t = random_sparse((12, 9, 7), 200, seed=2)
    with trace.capture() as tr:
        make_plan(t, 3, device="cpu")
    spans = {r["id"]: r for r in tr.records() if r["kind"] == "span"}
    sorts = [r for r in spans.values() if r["name"] == "plan.sort"]
    assert [r["args"]["mode"] for r in sorts] == [0, 1, 2]
    assert {spans[r["parent"]]["name"] for r in sorts} == {"plan.layouts"}


def _reference_module():
    path = Path(__file__).resolve().parents[1] / "bench" / "reference" / "cp_als.py"
    spec = importlib.util.spec_from_file_location("plain_cp_als", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", [0, 1])
def test_enron_shaped_stand_in_matches_plain_reference(seed):
    """FROSTT enron's mode lengths over 100 (61 x 57 x 2443 x 12, one
    mode 40x longer than the rest): ``cpd_als`` on a plan made through
    the device path matches plain float64 CP-ALS from the same start."""
    shape, rank, sweeps = (61, 57, 2443, 12), 8, 6
    t = random_sparse(shape, 6000, seed=seed, distribution="powerlaw")
    rng = np.random.default_rng(seed)
    init = [rng.standard_normal((I, rank)).astype(np.float32) for I in shape]
    state = als_device.state_from_factors(init)
    res = cpd_als(t, rank, plan=make_plan(t, 1, device="cpu"),
                  n_iters=sweeps, check_every=5, tol=0.0, init_state=state,
                  device="cpu")
    ref = _reference_module()
    rf, rw, rfits = ref.cp_als(torch.as_tensor(t.indices),
                               torch.as_tensor(t.values), shape, init, sweeps)
    assert res.iters == sweeps
    np.testing.assert_allclose(res.fits, rfits.numpy(), rtol=0, atol=1e-5)
    for F, G in zip(res.factors, rf):
        G = G.numpy()
        assert np.linalg.norm(F - G) <= 1e-3 * np.linalg.norm(G)
    np.testing.assert_allclose(res.weights, rw.numpy(), rtol=1e-3)
