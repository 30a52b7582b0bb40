"""The stand-in generator: the seed alone fixes it; unique coordinates;
the exact shape and nonzero count; skewed, scattered degrees."""
import numpy as np
import pytest

from bench.harness import data

SHAPE = (300, 24, 77, 32)
NNZ = 20_000
BIG_SEED = 2 ** 31 + 12_345


@pytest.fixture(scope="module")
def tensor():
    return data.stand_in(SHAPE, NNZ, BIG_SEED, device="cpu")


def test_same_seed_same_tensor(tensor):
    idx, vals = data.stand_in(SHAPE, NNZ, BIG_SEED, device="cpu")
    np.testing.assert_array_equal(idx, tensor[0])
    np.testing.assert_array_equal(vals, tensor[1])
    other, _ = data.stand_in(SHAPE, NNZ, BIG_SEED + 1, device="cpu")
    assert not np.array_equal(other, tensor[0])


def test_exact_shape_count_and_unique(tensor):
    idx, vals = tensor
    assert idx.shape == (NNZ, 4) and idx.dtype == np.int32
    assert vals.shape == (NNZ,) and vals.dtype == np.float32
    assert (idx >= 0).all() and (idx.max(axis=0) < np.array(SHAPE)).all()
    keys = np.ravel_multi_index(idx.T.astype(np.int64), SHAPE)
    assert len(np.unique(keys)) == NNZ
    assert (np.diff(keys) > 0).all()          # row-major order
    assert (np.abs(vals) >= 1e-3).all()
    assert abs(float(vals.mean())) < 0.05 and 0.9 < float(vals.std()) < 1.1


def test_degrees_are_skewed_and_scattered(tensor):
    idx, _ = tensor
    deg = np.bincount(idx[:, 0], minlength=SHAPE[0])
    assert deg.max() > 5 * deg.mean()         # power law, not uniform
    hottest = np.argsort(deg)[::-1][:10]
    assert not np.array_equal(np.sort(hottest), np.arange(10))  # permuted


def test_init_factors_from_seed_and_call():
    a = data.init_factors(SHAPE, 8, BIG_SEED, 3)
    b = data.init_factors(SHAPE, 8, BIG_SEED, 3)
    c = data.init_factors(SHAPE, 8, BIG_SEED, 4)
    assert [f.shape for f in a] == [(I, 8) for I in SHAPE]
    assert all(f.dtype == np.float32 for f in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_too_many_cells_for_keys_is_refused():
    with pytest.raises(ValueError):
        data.stand_in((2_902_330, 2_143_368, 25_495_389), 10, 0, device="cpu")
