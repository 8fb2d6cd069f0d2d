"""Host-side page allocator for the paged KV pool.

The device side (models/attention.py:paged_attend) only sees block tables;
this class owns which physical page belongs to which request. Page 0 is the
reserved null/scratch page: it is never handed out, every unallocated block
table entry points at it, and dead/padding decode lanes scatter into it.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class PagedKVCache:
    """Free-list page allocator over a pool of ``n_pages`` fixed-size pages.

    Pages are recycled LIFO so a drained-then-refilled engine reuses hot
    pages instead of sweeping the pool.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO free list, page 0 excluded (reserved null/scratch page).
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._owned: Dict[object, List[int]] = {}

    # ------------------------------------------------------------- capacity
    def pages_needed(self, total_len: int) -> int:
        return -(-total_len // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_alloc(self, total_len: int) -> bool:
        return self.pages_needed(total_len) <= len(self._free)

    # ------------------------------------------------------------ alloc/free
    def alloc(self, rid, total_len: int) -> List[int]:
        """Reserve pages covering ``total_len`` positions for request ``rid``."""
        if rid in self._owned:
            raise KeyError(f"request {rid!r} already holds pages")
        need = self.pages_needed(total_len)
        if need > len(self._free):
            raise MemoryError(
                f"paged KV pool exhausted: need {need}, free {len(self._free)}")
        pages = [self._free.pop() for _ in range(need)]
        self._owned[rid] = pages
        return list(pages)

    def free(self, rid) -> None:
        """Return ``rid``'s pages to the free list (LIFO reuse)."""
        self._free.extend(reversed(self._owned.pop(rid)))

    # ------------------------------------------------------------ block table
    def block_table(self, rid, n_blocks: int) -> np.ndarray:
        """(n_blocks,) int32 table; entries past the allocation map to the
        reserved page 0."""
        pages = self._owned[rid]
        if len(pages) > n_blocks:
            raise ValueError(
                f"request {rid!r} holds {len(pages)} pages > table width "
                f"{n_blocks}")
        t = np.zeros((n_blocks,), np.int32)
        t[:len(pages)] = pages
        return t
