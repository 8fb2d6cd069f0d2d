"""Data: the reference's deterministic synthetic token stream."""
from .pipeline import DataIterator, DatasetSpec, make_dataset

__all__ = ["DataIterator", "DatasetSpec", "make_dataset"]
