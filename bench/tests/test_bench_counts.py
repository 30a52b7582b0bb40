"""The counts of work against hand counts at a tiny shape."""
from bench.harness import counts


def test_mttkrp_counts_by_hand():
    # shape (5, 4, 3), 7 nonzeros, rank 2, mode 0: each nonzero's 3
    # indices and value (7 x 16 bytes), factors 1 and 2 (4 + 3 rows x 2 x
    # 4 bytes), the output (5 x 2 x 4); 7 x 2 x 3 operations.
    c = counts.mttkrp_counts((5, 4, 3), 7, 2, 0)
    assert c == {"bytes": 112 + 56 + 40, "flops": 42}
    c2 = counts.mttkrp_counts((5, 4, 3), 7, 2, 2)
    assert c2 == {"bytes": 112 + (5 + 4) * 8 + 3 * 8, "flops": 42}


def test_sweep_counts_by_hand():
    shape, nnz, rank = (5, 4, 3), 7, 2
    s = counts.sweep_counts(shape, nnz, rank)
    modes = [counts.mttkrp_counts(shape, nnz, rank, d) for d in range(3)]
    assert s["bytes"] == sum(m["bytes"] for m in modes) == 3 * 112 + 3 * 96
    grams_solves = sum(4 * I * rank ** 2 + rank ** 3 for I in shape)
    assert s["flops"] == 3 * 42 + grams_solves + 2 * 3 * rank


def test_least_seconds_takes_the_longer_bound():
    peaks = {"hbm_bytes_per_s": 100.0, "fp32_flops_per_s": 10.0}
    assert counts.least_seconds({"bytes": 200, "flops": 10}, peaks) == 2.0
    assert counts.least_seconds({"bytes": 100, "flops": 50}, peaks) == 5.0


def test_chicago_mode_is_about_107_megabytes():
    c = counts.mttkrp_counts((6186, 24, 77, 32), 5_330_673, 32, 0)
    assert 107.0e6 < c["bytes"] < 107.8e6
    assert 31e-6 < counts.least_seconds(c) < 33e-6


def test_sweep_roofline_reads_device_busy_time_per_sweep():
    # Two traced calls of 25 sweeps; the device busy 3 + 2 of the 10 us
    # window, overlapping intervals counted once: 5e-6 s over 50 sweeps.
    import types

    from bench.harness import devtime, spec

    read = spec.metric_reader("sweep_roofline")
    done = types.SimpleNamespace(ok=True, result=types.SimpleNamespace(iters=25))
    tr = devtime.Trace(device=[("a", 0.0, 3.0), ("b", 1.0, 2.0),
                               ("c", 6.0, 8.0)],
                       host=[], start_us=0.0, end_us=10.0,
                       result=[done, done])
    run = types.SimpleNamespace(traced=tr, shape=(5, 4, 3), nnz=7, rank=2)
    least = counts.least_seconds(counts.sweep_counts((5, 4, 3), 7, 2))
    assert read(run) == 100.0 * least / (5e-6 / 50)
    run.traced = None
    assert read(run) is None
