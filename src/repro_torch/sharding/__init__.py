"""The device mesh on ``torch.distributed`` (the reference's ``sharding/``
context) and the port's collectives. The reference's logical rule tables
(``sharding/logical.py``: FSDP and tensor-parallel placement) are not
ported: under a mesh the port shards only the experts, over "model", and
replicates every other leaf (ROADMAP.md, queue 1 item 8)."""
from .collectives import (CALLS, all_reduce_, all_reduce_sum, all_to_all, batch_count,
                          batch_logsumexp, batch_mean, batch_sum, pmean,
                          reset_call_counts)
from .context import Mesh, axis_size, current_mesh, global_draw, mesh_context

__all__ = ["CALLS", "Mesh", "all_reduce_", "all_reduce_sum", "all_to_all", "axis_size",
           "batch_count", "batch_logsumexp", "batch_mean", "batch_sum", "current_mesh",
           "global_draw", "mesh_context", "pmean", "reset_call_counts"]
