"""Port vs JAX package: the LM token pipeline (``repro_torch.data``), numpy
only on both sides.

The port's batches equal the reference's bitwise for several seeds,
steps and shapes; ``snapshot``/``restore`` resumes the same stream; the
rank slices of a step concatenate to the global batch, also the
reference's (``tests/substrate/test_checkpoint_runtime.py``'s
``test_pipeline_determinism_and_restore``).
"""
import numpy as np
import pytest

from repro.data import PipelineState as RefState
from repro.data import TokenPipeline as RefPipeline
from repro_torch.data import PipelineState, TokenPipeline

CASES = [(1000, 4, 16, 5), (512, 8, 24, 0), (151_655, 2, 33, 123)]


@pytest.mark.parametrize("vocab,batch,seq,seed", CASES)
def test_batches_equal_the_reference_bitwise(vocab, batch, seq, seed):
    port, ref = TokenPipeline(vocab, batch, seq, seed=seed), RefPipeline(vocab, batch, seq, seed=seed)
    for _ in range(4):
        a, b = next(port), next(ref)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            assert a[k].shape == (batch, seq)
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
        assert 0 <= a["tokens"].min() and a["tokens"].max() < vocab


def test_snapshot_restore_resumes_the_stream():
    p1 = TokenPipeline(1000, batch=4, seq_len=16, seed=5)
    for _ in range(5):
        next(p1)
    snap = p1.snapshot()
    assert snap == {"seed": 5, "step": 5}
    more = [next(p1) for _ in range(3)]
    p2 = TokenPipeline(1000, batch=4, seq_len=16, seed=5)
    p2.restore(snap)
    ref = RefPipeline(1000, batch=4, seq_len=16, seed=5)
    ref.restore(snap)
    for a in more:
        b, c = next(p2), next(ref)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], c["labels"])
    assert PipelineState.from_dict(snap).to_dict() == RefState.from_dict(snap).to_dict()


@pytest.mark.parametrize("ranks", [2, 4])
def test_rank_slices_concatenate_to_the_global_batch(ranks):
    whole = TokenPipeline(1000, batch=8, seq_len=16, seed=5)
    parts = [TokenPipeline(1000, batch=8, seq_len=16, seed=5, process_index=r,
                           process_count=ranks) for r in range(ranks)]
    refs = [RefPipeline(1000, batch=8, seq_len=16, seed=5, process_index=r,
                        process_count=ranks) for r in range(ranks)]
    for _ in range(3):
        g = next(whole)
        slices = [next(p) for p in parts]
        for s, r in zip(slices, refs):
            assert s["tokens"].shape == (8 // ranks, 16)
            np.testing.assert_array_equal(s["tokens"], next(r)["tokens"])
        for k in g:
            np.testing.assert_array_equal(np.concatenate([s[k] for s in slices]), g[k])


def test_a_batch_that_does_not_split_is_refused():
    with pytest.raises(ValueError):
        TokenPipeline(1000, batch=6, seq_len=16, process_count=4)
