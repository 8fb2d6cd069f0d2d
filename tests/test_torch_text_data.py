"""The port's byte-level corpus reader against the reference's, on a file in
the repo (README.md): the same vocabulary and int32 data, the same batches
for a seed and step, the same host slices, and ``state()``/``restore()``
resuming the same stream."""
from pathlib import Path

import numpy as np
import pytest

from repro.data import DataIterator as JaxDataIterator
from repro.data import make_dataset as jax_make_dataset
from repro_torch.data import DataIterator, make_dataset

CORPUS = str(Path(__file__).resolve().parents[1] / "README.md")


@pytest.mark.parametrize("vocab,seed", [(256, 0), (8000, 5)])
def test_byte_corpus_batches_equal_reference(vocab, seed):
    spec, jspec = make_dataset(CORPUS, vocab), jax_make_dataset(CORPUS, vocab)
    assert spec.kind == jspec.kind == "text"
    assert spec.vocab_size == jspec.vocab_size == max(vocab, int(spec.data.max()) + 1)
    assert spec.data.dtype == np.int32
    np.testing.assert_array_equal(spec.data, jspec.data)
    it, jit = DataIterator(spec, 4, 33, seed=seed), JaxDataIterator(jspec, 4, 33, seed=seed)
    for _ in range(3):
        got = it.next()["tokens"]
        np.testing.assert_array_equal(got, jit.next()["tokens"])
        assert got.shape == (4, 33) and got.dtype == np.int32
    assert it.step == jit.step == 3


def test_byte_iterator_state_restore_resumes_the_stream():
    spec = make_dataset(CORPUS, 256)
    it = DataIterator(spec, 4, 17, seed=3)
    for _ in range(2):
        it.next()
    state = it.state()
    assert state == {"step": 2, "seed": 3}
    want = [it.next()["tokens"] for _ in range(3)]
    resumed = DataIterator(spec, 4, 17, seed=99)
    resumed.restore(state)
    jresumed = JaxDataIterator(jax_make_dataset(CORPUS, 256), 4, 17, seed=99)
    jresumed.restore(state)
    for w in want:
        np.testing.assert_array_equal(resumed.next()["tokens"], w)
        np.testing.assert_array_equal(jresumed.next()["tokens"], w)


def test_host_slices_equal_reference():
    spec, jspec = make_dataset(CORPUS, 256), jax_make_dataset(CORPUS, 256)
    full = DataIterator(spec, 6, 9, seed=1).next()["tokens"]
    parts = []
    for host in range(3):
        got = DataIterator(spec, 6, 9, seed=1, host_index=host, host_count=3).next()
        want = JaxDataIterator(jspec, 6, 9, seed=1, host_index=host, host_count=3).next()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        parts.append(got["tokens"])
    np.testing.assert_array_equal(np.concatenate(parts), full)
    with pytest.raises(ValueError):
        DataIterator(spec, 5, 9, host_count=3)
