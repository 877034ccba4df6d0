"""Multi-process helpers (counterpart of ``pcaudio/parallel/multihost.py``).

The JAX package initializes its distributed runtime once per host, builds
one mesh over every host's devices, and feeds each host its batch shard.
Here every rank is a process of its own: initialize the process group,
build the mesh over all its ranks, and feed each rank its shard on its own
device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from pcaudio_torch.parallel.mesh import Mesh, _to_device, make_mesh


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """``dist.init_process_group``; a no-op where the group is already up,
    as the JAX one is.

    ``backend`` is named, or follows the device: ``nccl`` where there is a
    card, ``gloo`` on the CPU.  A backend that fails to initialize raises;
    none gives way to another.  ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)."""
    if dist.is_initialized():
        if backend is not None and backend != dist.get_backend():
            raise RuntimeError(f"torch.distributed is up with "
                               f"{dist.get_backend()!r}, not {backend!r}")
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def global_mesh(n_set: int = 1, device=None) -> Mesh:
    """The mesh over every rank of the default group: ``(data, set)``."""
    return make_mesh(n_set=n_set, device=device)


def local_batch_slice(global_batch: int, mesh: Mesh) -> slice:
    """This rank's rows of a globally indexed batch of ``global_batch``.

    Sliced by the rank's ``data`` coordinate and ``n_data``, where JAX
    slices by ``process_index`` and ``process_count``: a JAX process holds
    several devices of the mesh, a rank here holds one, and the ranks of a
    ``set`` group (one data coordinate) must all get the same rows."""
    if global_batch % mesh.n_data:
        raise ValueError(f"a global batch of {global_batch} does not divide "
                         f"over {mesh.n_data} data ranks")
    per = global_batch // mesh.n_data
    start = mesh.data_index * per
    return slice(start, start + per)


def global_batch_array(mesh: Mesh, local_tree):
    """This rank's shard of a global batch on this rank's device: the
    leaves of ``local_tree`` are rows the caller has already cut out
    (:func:`local_batch_slice`), so each rank touches only its own; the
    counterpart of JAX's ``make_array_from_process_local_data``."""
    return _to_device(mesh, local_tree)
