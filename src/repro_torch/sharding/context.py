"""The device mesh and the process-wide mesh context (the reference's
``sharding/context.py``).

One rank of ``torch.distributed`` is one process and one device. A
``Mesh`` lays the ranks out row-major over named axes (``("data",
"model")``, as ``launch/mesh.py`` builds it) and holds this rank's
coordinates and, for every set of axes, the process group of the ranks
that differ from this one only along those axes. A mesh of one rank may
have no process group; there every collective is the identity.

Model code never builds meshes: the launcher installs one here with
``mesh_context``, and the code that reduces over the batch reads
``current_mesh()``. With no mesh installed every path computes on the one
process's batch, as before.

A rank holds block ``Mesh.index`` of every global batch (of every global
microbatch under gradient accumulation): the reference shards the tokens
over every mesh axis in this order. ``global_draw`` makes a random draw
for the whole batch, as one process would, and keeps this rank's block,
so that dropout and gating noise equal one process's.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

_state = threading.local()


@dataclass(frozen=True)
class Mesh:
    """Named axes over ranks. ``shape`` maps each axis to its size (the
    reference reads ``mesh.shape["model"]``), ``coords`` this rank's place
    on each axis; ``groups`` maps a tuple of axis names (in mesh order) to
    this rank's process group over those axes, and is empty on a mesh of
    one rank without ``torch.distributed``."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device = torch.device("cpu")
    groups: Dict[Tuple[str, ...], Any] = field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape[a] for a in self.axis_names)

    @property
    def index(self) -> int:
        """This rank's row-major place on the mesh: its block of the batch."""
        i = 0
        for a in self.axis_names:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, *axes: str):
        """The process group over ``axes`` (every axis when none is named),
        or None where the mesh has no process group."""
        wanted = set(axes or self.axis_names)
        return self.groups.get(tuple(a for a in self.axis_names if a in wanted))

    def local_rows(self, t: torch.Tensor, micro: int = 1) -> torch.Tensor:
        """This rank's rows of a global batch ``t`` (rows first) split into
        ``micro`` microbatches: its block of each, in order."""
        rows = t.shape[0]
        if rows % (micro * self.size):
            raise ValueError(f"a batch of {rows} rows does not split into {micro} "
                             f"microbatches over {self.size} ranks")
        share = rows // (micro * self.size)
        return t.reshape(micro, self.size, share, *t.shape[1:])[:, self.index].reshape(
            micro * share, *t.shape[1:])


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


def axis_size(name: str) -> int:
    mesh = current_mesh()
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh]):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def global_draw(draw: Callable[[Tuple[int, ...]], torch.Tensor],
                shape: Tuple[int, ...]) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows (``shape[0]`` of them) as one
    process draws it for the whole batch: under a mesh of R ranks the draw
    is made for R times the rows and this rank's block is kept, so the
    generator also advances as one process's does."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return draw(tuple(shape))
    n = shape[0]
    full = draw((n * mesh.size, *shape[1:]))
    return full[mesh.index * n:(mesh.index + 1) * n]
