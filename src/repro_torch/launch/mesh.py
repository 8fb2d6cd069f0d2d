"""Mesh construction on ``torch.distributed`` (the reference's
``launch/mesh.py``). One rank is one process and one device.

The ranks come from ``torch.distributed.run``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``; ``LOCAL_RANK`` picks ``cuda:N``): the first
constructor called starts the default process group from it, with NCCL on
CUDA and gloo on the CPU, unless the caller started one already. Without a
launcher and without a group the world is this one process, and a mesh of
one rank has no process group.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --mesh 2x2 ...
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Tuple

import torch
import torch.distributed as dist

from ..sharding import Mesh

# Every mesh axis layout the port constructs (the reference's table; its
# constructors below use these).
MESH_AXIS_LAYOUTS: Tuple[Tuple[str, ...], ...] = (
    ("data", "model"),            # single pod / local default
    ("pod", "data", "model"),     # multi-pod: leading DCN axis
)


def _start(device) -> torch.device:
    """This rank's device; starts the default process group from
    ``torch.distributed.run``'s environment where it set one and no group
    is up."""
    dev = torch.device(device)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a mesh of CPU ranks")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if launched and not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return dev


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` on every rank of the world, ranks
    laid out row-major; raises unless the world has exactly
    ``prod(shape)`` ranks. Every rank must call it (it makes the process
    groups, one for each set of axes)."""
    if len(shape) != len(axes) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    dev = _start(device)
    n, world = math.prod(shape), _world()
    if world != n:
        raise ValueError(
            f"mesh {shape} over {axes} needs {n} ranks, the world has {world}: start one "
            f"process a device with `python -m torch.distributed.run --nproc-per-node {n}`")
    rank = dist.get_rank() if dist.is_initialized() else 0
    every = list(itertools.product(*(range(size) for size in shape)))   # rank order
    groups = {}
    if dist.is_initialized():
        for r in range(1, len(axes) + 1):
            for sub in itertools.combinations(range(len(axes)), r):
                fixed = [i for i in range(len(axes)) if i not in sub]
                for rest in itertools.product(*(range(shape[i]) for i in fixed)):
                    ranks = [j for j, c in enumerate(every)
                             if all(c[i] == v for i, v in zip(fixed, rest))]
                    group = dist.new_group(ranks)
                    if rank in ranks:
                        groups[tuple(axes[i] for i in sub)] = group
    return Mesh(axis_names=tuple(axes), shape=dict(zip(axes, shape)),
                coords=dict(zip(axes, every[rank])), device=dev, groups=groups)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod adds the DCN
    'pod' axis: (pod=2, data=16, model=16) = 512 ranks. Raises unless the
    world has exactly that many."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = MESH_AXIS_LAYOUTS[1] if multi_pod else MESH_AXIS_LAYOUTS[0]
    _start(device)
    n, world = math.prod(shape), _world()
    if world != n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, have {world}")
    return make_mesh(shape, axes, device)


def make_local_mesh(model: int = 1, pod: int = 1, device="cuda") -> Mesh:
    """Whatever the world has: (data=n/(pod*model), model), with a leading
    DCN 'pod' axis when pod > 1.

    Raises when the requested axis sizes do not tile the device count: the old
    behavior silently built a (n//model, model) mesh that DROPPED devices (8
    devices, model=3 -> a 6-device mesh with 2 chips idle).
    """
    _start(device)
    n = _world()
    if model < 1 or pod < 1:
        raise ValueError(f"mesh axis sizes must be >= 1, got model={model} pod={pod}")
    if n % (model * pod):
        divisors = [d for d in range(1, n + 1) if n % d == 0]
        raise ValueError(
            f"make_local_mesh: model={model} * pod={pod} does not divide the "
            f"device count {n} — a (n//model, model) mesh would silently drop "
            f"{n - (n // (model * pod)) * model * pod} device(s). Pick axis "
            f"sizes whose product divides {n} (divisors: {divisors}).")
    data = n // (model * pod)
    if pod > 1:
        return make_mesh((pod, data, model), MESH_AXIS_LAYOUTS[1], device)
    return make_mesh((data, model), MESH_AXIS_LAYOUTS[0], device)
