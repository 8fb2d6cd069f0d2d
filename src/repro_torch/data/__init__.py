"""Data: the reference's deterministic synthetic token stream and byte-level
corpora, behind a checkpointable iterator."""
from .pipeline import DataIterator, DatasetSpec, make_dataset

__all__ = ["DataIterator", "DatasetSpec", "make_dataset"]
