"""Device-mesh helpers (counterpart of ``jstsp19_tpu/parallel/mesh.py``).

Mesh axes of this workload:
  dp — data parallel over Monte-Carlo channel realizations
  sp — sequence parallel over the training-frame axis T
  tp — tensor parallel over the beamspace grid axis Gr

One rank drives one device, so a mesh of n ranks is a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks in
row-major (dp, sp, tp) order; each axis's process group carries that axis's
all-reduces (``parallel/sharded_admm.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def mesh_shape_for(n_devices: int) -> Tuple[int, int, int]:
    """Factor n_devices into (dp, sp, tp): a factor 2 to tp and then to sp
    while what is left is even, the rest to dp (the JAX package's rule)."""
    if n_devices <= 0:
        raise ValueError("need at least one device")
    dp, sp, tp = 1, 1, 1
    n = n_devices
    for target in ("tp", "sp"):
        if n % 2 == 0 and n > 1:
            if target == "tp":
                tp = 2
            else:
                sp = 2
            n //= 2
    dp = n
    return dp, sp, tp


def mesh_of_shape(shape: Tuple[int, int, int]):
    """A (dp, sp, tp) ``DeviceMesh`` of this shape over every rank of the
    initialized process group; every rank must call it (it makes each
    axis's group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from jstsp19_torch.parallel.distributed import comm_device

    n = shape[0] * shape[1] * shape[2]
    if n != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks, the world has {dist.get_world_size()}")
    # the mesh's device type is where its groups' collectives take tensors
    return DeviceMesh(comm_device().type, torch.arange(n).reshape(shape), mesh_dim_names=("dp", "sp", "tp"))


def make_mesh(n_devices: Optional[int] = None):
    """The (dp, sp, tp) mesh of ``mesh_shape_for(n)`` over the world's ranks
    (n: the world size unless given, and it must be the world size)."""
    import torch.distributed as dist

    return mesh_of_shape(mesh_shape_for(n_devices or dist.get_world_size()))
