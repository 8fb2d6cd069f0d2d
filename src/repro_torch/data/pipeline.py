"""Data (a numpy copy of the reference's ``data/pipeline.py``): the
deterministic synthetic language-model stream and byte-level text corpora,
behind a checkpointable iterator.

The global batch of step t is a pure function of (seed, t), so the port and
the reference read the very same tokens, and a resumed run reads the
stream it would have read uninterrupted. Each host takes its slice of the
global batch (``host_index`` of ``host_count``).

The synthetic stream mixes Zipf-distributed unigrams with a copy task (the
second half of each row repeats the first), so next-token loss falls
measurably within tens of steps. A text corpus is a local file read as
bytes (enwik8-style); a row is ``seq_len`` bytes from a random start.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class DatasetSpec:
    kind: str                  # "synthetic" | "text"
    vocab_size: int
    data: Optional[np.ndarray] = None      # int32 token ids for kind="text"


def make_dataset(source: str, vocab_size: int) -> DatasetSpec:
    """"synthetic", or the path of a local file read as a byte corpus; its
    vocabulary is the larger of the bytes seen and ``vocab_size``."""
    if source == "synthetic":
        return DatasetSpec(kind="synthetic", vocab_size=vocab_size)
    with open(source, "rb") as f:
        raw = np.frombuffer(f.read(), dtype=np.uint8)
    return DatasetSpec(kind="text", vocab_size=max(int(raw.max()) + 1, vocab_size),
                       data=raw.astype(np.int32))


class DataIterator:
    """Iterator of {"tokens": (local batch, seq_len) int32} batches. ``step``
    counts the batches drawn so far; ``state()``/``restore()`` resume the
    exact stream."""

    def __init__(self, spec: DatasetSpec, global_batch: int, seq_len: int,
                 seed: int = 0, host_index: int = 0, host_count: int = 1):
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{host_count} hosts")
        self.spec = spec
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = global_batch // host_count
        self.step = 0

    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: Dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state.get("seed", self.seed))

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, step))

    def _synthetic_batch(self, step: int) -> np.ndarray:
        rng = self._rng_for(step)
        v = self.spec.vocab_size
        b, s = self.global_batch, self.seq_len
        probs = 1.0 / np.arange(1, v + 1)                 # Zipf unigrams
        probs /= probs.sum()
        toks = rng.choice(v, size=(b, s), p=probs)
        half = s // 2                                     # copy structure
        if half > 1:
            toks[:, half:half * 2] = toks[:, :half]
        return toks.astype(np.int32)

    def _text_batch(self, step: int) -> np.ndarray:
        rng = self._rng_for(step)
        data = self.spec.data
        b, s = self.global_batch, self.seq_len
        starts = rng.integers(0, len(data) - s - 1, size=(b,))
        return np.stack([data[st:st + s] for st in starts]).astype(np.int32)

    def next(self) -> Dict[str, np.ndarray]:
        full = (self._synthetic_batch(self.step) if self.spec.kind == "synthetic"
                else self._text_batch(self.step))
        lo = self.host_index * self.local_batch
        self.step += 1
        return {"tokens": full[lo:lo + self.local_batch]}
