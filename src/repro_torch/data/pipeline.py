"""The deterministic synthetic language-model stream (a numpy copy of the
reference's ``data/pipeline.py``): the batch of step t is a pure function
of (seed, t), so the port and the reference read the very same tokens.

The stream mixes Zipf-distributed unigrams with a copy task (the second
half of each row repeats the first), so next-token loss falls measurably
within tens of steps. Text corpora, multi-host slicing and the
checkpointable iterator state are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class DatasetSpec:
    kind: str                  # "synthetic"
    vocab_size: int


def make_dataset(source: str, vocab_size: int) -> DatasetSpec:
    if source != "synthetic":
        raise NotImplementedError(f"data {source!r}: only 'synthetic' is "
                                  "ported yet")
    return DatasetSpec(kind="synthetic", vocab_size=vocab_size)


class DataIterator:
    """Iterator of {"tokens": (batch, seq_len) int32} batches; ``step``
    counts the batches drawn so far."""

    def __init__(self, spec: DatasetSpec, global_batch: int, seq_len: int,
                 seed: int = 0):
        self.spec = spec
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.step = 0

    def _synthetic_batch(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step))
        v = self.spec.vocab_size
        b, s = self.global_batch, self.seq_len
        probs = 1.0 / np.arange(1, v + 1)                 # Zipf unigrams
        probs /= probs.sum()
        toks = rng.choice(v, size=(b, s), p=probs)
        half = s // 2                                     # copy structure
        if half > 1:
            toks[:, half:half * 2] = toks[:, :half]
        return toks.astype(np.int32)

    def next(self) -> Dict[str, np.ndarray]:
        batch = {"tokens": self._synthetic_batch(self.step)}
        self.step += 1
        return batch
