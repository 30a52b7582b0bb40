"""Deterministic, checkpointable data pipeline (port of
``repro.data.pipeline``, numpy only: the same code, so its batches are
the reference's bitwise for the same seed and step).

Large-scale requirement: after a preemption, the restarted trainer must
see exactly the batch sequence it would have seen — so the pipeline state
is just (seed, step) and batch generation is a pure function of them.
Rank sharding: each data-parallel rank keeps only its slice
(process_index/process_count) of the global batch; every rank draws the
whole batch (a pure function of seed and step) and slices it, so the
slices of a step concatenate to the global batch at any rank count.

The synthetic stream is a fixed-vocabulary Markov-ish token generator —
structure enough for a ~100M-param example model to show a real loss
curve (examples/train_lm_torch.py) without shipping a corpus in the container.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(int(d["seed"]), int(d["step"]))


class TokenPipeline:
    """Infinite deterministic token stream of (tokens, labels) batches."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int, *,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        if batch % process_count:
            raise ValueError("global batch must divide process count")
        self.vocab = int(vocab_size)
        self.batch = int(batch)
        self.local_batch = batch // process_count
        self.seq = int(seq_len)
        self.state = PipelineState(seed, 0)
        self.process_index = process_index
        self.process_count = process_count

    def _gen(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + step) % (2**63)
        )
        # the global batch, then this rank's slice of it
        all_tok = self._markov(rng, self.batch, self.seq + 1)
        lo = self.process_index * self.local_batch
        tok = all_tok[lo : lo + self.local_batch]
        return {
            "tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32),
        }

    def _markov(self, rng, b, s):
        """Blockwise-correlated stream: token_{t+1} = f(token_t) + noise.
        Gives a learnable bigram structure (loss drops below unigram)."""
        base = rng.integers(0, self.vocab, size=(b, 1), dtype=np.int64)
        steps = rng.integers(1, 17, size=(b, s), dtype=np.int64)
        noise = rng.random((b, s)) < 0.1
        rand = rng.integers(0, self.vocab, size=(b, s), dtype=np.int64)
        out = np.zeros((b, s), dtype=np.int64)
        cur = base[:, 0]
        for t in range(s):
            cur = (cur * 31 + steps[:, t]) % self.vocab
            cur = np.where(noise[:, t], rand[:, t], cur)
            out[:, t] = cur
        return out

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self._gen(self.state.step)
        self.state.step += 1
        return batch

    # -- checkpoint integration --------------------------------------------

    def snapshot(self) -> dict:
        return self.state.to_dict()

    def restore(self, d: dict):
        self.state = PipelineState.from_dict(d)
