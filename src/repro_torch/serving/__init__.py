"""Continuous-batching serving: paged KV cache, prefill/decode
disaggregation, and cached decode-shaped CVMM plans (the reference's
``serving`` package).

Block-table / KV-page contract (shared by models/attention.py:paged_attend,
models/stack.py:init_paged_stack_cache and serving/kv_cache.py):

* The per-layer cache is a POOL ``{"k": (P, page_size, KV, D), "v": ...}``
  of P fixed-size pages shared by all requests; join/evict never reshapes
  device state.
* Page 0 is the reserved scratch page. The allocator never hands it out;
  unallocated block-table entries point at it; dead decode lanes and the
  padded tail of a prefill chunk write into it; per-lane ``kv_len`` masking
  keeps its contents out of every softmax.
* A block table row ``(n_blocks,)`` maps a request's logical page j (token
  positions ``[j*page_size, (j+1)*page_size)``) to a physical page id. ONE
  table is shared by all layers.
* Decode writes one token at ``(table[pos // page_size], pos % page_size)``
  per lane; prefill chunks write one request (B == 1) at a time.
"""
from .decode_plan import DecodePlanCache, make_provider
from .engine import Engine, Request
from .kv_cache import PagedKVCache
from .scheduler import FifoScheduler, capture_sizes, pick_capture

__all__ = ["DecodePlanCache", "Engine", "FifoScheduler", "PagedKVCache",
           "Request", "capture_sizes", "make_provider", "pick_capture"]
