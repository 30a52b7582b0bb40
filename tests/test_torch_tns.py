"""Port vs JAX package: FROSTT ``.tns`` files, on the CPU.

A file written by one package and read by the other gives bitwise the
same indices, values and inferred shape, plain and gzipped, and the
bytes each package writes are the same.  Values pass through ``%.9g``,
which round-trips float32 exactly.  Comment lines are skipped, and the
errors for an empty and for a 0-based file are the reference's.  A
decomposition of the read tensor is bitwise one of the original.
"""
import gzip

import numpy as np
import pytest

from repro.core import coo as r_coo
from repro.data import tns as r_tns
from repro_torch.core import coo as t_coo
from repro_torch.core.cpd import cpd_als
from repro_torch.data import read_tns, write_tns

CASES = [((16, 12, 9), 400, "uniform"), ((40, 7, 33, 5), 1500, "powerlaw"),
         ((9, 6, 5, 4, 3), 300, "zipf")]


def assert_bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def assert_same_tensor(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    assert_bitwise(a.indices, b.indices)
    assert_bitwise(a.values, b.values)


@pytest.mark.parametrize("suffix", [".tns", ".tns.gz"])
@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("shape,nnz,distribution", CASES)
def test_written_by_one_read_by_the_other(tmp_path, shape, nnz, distribution,
                                          writer, suffix):
    t = t_coo.random_sparse(shape, nnz, seed=7, distribution=distribution)
    path = str(tmp_path / f"x{suffix}")
    (write_tns if writer == "port" else r_tns.write_tns)(path, t)
    port, ref = read_tns(path), r_tns.read_tns(path)
    assert_same_tensor(port, ref)
    assert_bitwise(port.indices, t.indices)
    assert_bitwise(port.values, t.values)          # %.9g round-trips float32
    assert port.shape == tuple(int(m) + 1 for m in t.indices.max(axis=0))


@pytest.mark.parametrize("suffix", [".tns", ".tns.gz"])
def test_both_packages_write_the_same_bytes(tmp_path, suffix):
    t = t_coo.random_sparse((40, 7, 33, 5), 1500, seed=2, distribution="powerlaw")
    r = r_coo.random_sparse((40, 7, 33, 5), 1500, seed=2, distribution="powerlaw")
    a, b = str(tmp_path / f"a{suffix}"), str(tmp_path / f"b{suffix}")
    write_tns(a, t)
    r_tns.write_tns(b, r)
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(a, "rb") as fa, opener(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_comments_blank_lines_and_dtype(tmp_path, dtype):
    path = tmp_path / "c.tns"
    path.write_text("# FROSTT header\n% matrix-market style comment\n\n"
                    "1 2 3 1.5\n  4 1 2 -0.25  \n2 2 2 3e-3\n")
    port, ref = read_tns(str(path), dtype=dtype), r_tns.read_tns(str(path), dtype=dtype)
    assert_same_tensor(port, ref)
    assert port.shape == (4, 2, 3) and port.values.dtype == dtype
    assert port.indices.tolist() == [[0, 1, 2], [3, 0, 1], [1, 1, 1]]


@pytest.mark.parametrize("text,match", [
    ("", "empty tensor file"),
    ("# only a comment\n\n", "empty tensor file"),
    ("1 1 1 2.0\n0 3 1 1.0\n", "index underflow"),
], ids=["empty", "comments_only", "zero_based"])
def test_errors_match_the_reference(tmp_path, text, match):
    path = str(tmp_path / "bad.tns")
    with open(path, "w") as f:
        f.write(text)
    messages = []
    for read in (read_tns, r_tns.read_tns):
        with pytest.raises(ValueError, match=match) as exc:
            read(path)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_decomposition_of_the_read_tensor_is_bitwise(tmp_path):
    t = t_coo.random_sparse((20, 15, 10), 600, seed=4, distribution="powerlaw")
    path = str(tmp_path / "d.tns.gz")
    write_tns(path, t)
    back = read_tns(path)
    if back.shape != t.shape:          # an empty last slice is not in the file
        back = t_coo.SparseTensor(back.indices, back.values, t.shape)
    kw = dict(n_iters=4, check_every=2, seed=1, device="cpu")
    a, b = cpd_als(t, 3, **kw), cpd_als(back, 3, **kw)
    assert a.fits == b.fits
    for x, y in zip(a.factors, b.factors):
        assert_bitwise(x, y)
