"""The ``(data, set)`` mesh over ``torch.distributed`` (counterpart of
``pcaudio/parallel/mesh.py``).

JAX runs one process over a mesh of devices; PyTorch runs one process per
device.  So the mesh here is an SPMD program of ranks: the ranks of a
process group laid out as ``[n_data, n_set]`` (rank ``r`` at
``(r // n_set, r % n_set)``, as JAX reshapes its device list), each rank
holding its coordinates, the group of its ``data`` axis (the ranks with its
set coordinate: gradients and metrics are averaged over it) and the group
of its ``set`` axis (the ranks with its data coordinate: the set-sharded
ST's collectives run over it).

The groups are made by ``dist.new_group`` behind a small dataclass, not by
``init_device_mesh``: the device mesh picks a device per rank from the
device type, and the smoke run puts several ranks on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from pcaudio_torch.core.device import resolve_device

DATA_AXIS = "data"
SET_AXIS = "set"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``[n_data, n_set]`` mesh of ranks.

    ``rank`` is the rank in ``group`` (the mesh's process group, whose
    global ranks are ``ranks``), ``data_index`` / ``set_index`` its
    coordinates; ``data_group`` holds
    the ``n_data`` ranks with this rank's set coordinate, ``set_group`` the
    ``n_set`` ranks with its data coordinate; ``device`` is where this
    rank's shards go."""

    n_data: int
    n_set: int
    rank: int
    data_index: int
    set_index: int
    ranks: tuple
    group: Any
    data_group: Any
    set_group: Any
    device: torch.device


def _device(device) -> torch.device:
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else "cuda"
    return resolve_device(device)


def make_mesh(n_data: Optional[int] = None, n_set: int = 1, group=None,
              device=None) -> Mesh:
    """Arrange the ranks of ``group`` (default: the default process group)
    as ``[n_data, n_set]``; ``n_data`` defaults to every rank on ``data``.

    Every rank of the group calls this with the same arguments (it makes
    ``n_data + n_set`` new groups, collectively).  Unlike JAX, which may
    leave devices out of a mesh, every rank must be in it:
    ``n_data · n_set`` is the group's size.  ``device`` is where this
    rank's shards and model go: default the current CUDA device (raises
    without a card); the CPU only when named."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "initialize_distributed first")
    ranks = dist.get_process_group_ranks(group) if group is not None \
        else list(range(dist.get_world_size()))
    if n_data is None:
        n_data = len(ranks) // n_set
    if n_data < 1 or n_set < 1 or n_data * n_set != len(ranks):
        raise ValueError(f"mesh {n_data}x{n_set} does not cover the group's "
                         f"{len(ranks)} ranks")
    rank = dist.get_rank(group)
    di, si = divmod(rank, n_set)
    data_group = set_group = None
    for s in range(n_set):   # every rank makes every group, in one order
        g = dist.new_group([ranks[d * n_set + s] for d in range(n_data)])
        if s == si:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([ranks[d * n_set + s] for s in range(n_set)])
        if d == di:
            set_group = g
    return Mesh(n_data, n_set, rank, di, si, tuple(ranks),
                group if group is not None else dist.group.WORLD,
                data_group, set_group, _device(device))


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """What :func:`shard_batch` slices by: axis 0 into ``n_data`` parts
    (part ``data_index``), and with ``set_axis`` axis 1 of leaves with
    ndim >= 2 into ``n_set`` parts (part ``set_index``)."""

    n_data: int
    data_index: int
    n_set: int
    set_index: int
    set_axis: bool

    def slice(self, x: torch.Tensor) -> torch.Tensor:
        x = _axis_part(x, 0, self.n_data, self.data_index)
        if self.set_axis and x.dim() >= 2:
            x = _axis_part(x, 1, self.n_set, self.set_index)
        return x


def _axis_part(x: torch.Tensor, axis: int, parts: int, index: int):
    """Part ``index`` of ``parts`` equal parts of ``x`` along ``axis``;
    raises where they are not equal (JAX's NamedSharding does not pad)."""
    n = x.shape[axis]
    if n % parts:
        raise ValueError(f"axis {axis} of a leaf of shape {tuple(x.shape)} "
                         f"does not divide into {parts} shards")
    per = n // parts
    return x.narrow(axis, index * per, per)


def batch_sharding(mesh: Mesh, shard_set_axis: bool = False) -> BatchSharding:
    """This rank's part of a ``[B, N, ...]`` batch: the batch over ``data``,
    optionally the point axis over ``set``."""
    return BatchSharding(mesh.n_data, mesh.data_index, mesh.n_set,
                         mesh.set_index, shard_set_axis)


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, shard_set_axis: bool = False):
    """This rank's slice of each leaf of a host batch (numpy arrays or
    tensors, in dicts, lists or tuples), contiguous on ``mesh.device``:
    the leading axis over ``data``; with ``shard_set_axis``, axis 1 of
    every leaf with ndim >= 2 over ``set``.  Raises where an axis does not
    divide."""
    sharding = batch_sharding(mesh, shard_set_axis)
    return _to_device(mesh, _tree_map(
        lambda x: sharding.slice(torch.as_tensor(x)), tree))


def _to_device(mesh: Mesh, tree):
    """Each leaf of ``tree`` as a contiguous tensor on ``mesh.device``."""
    return _tree_map(lambda x: torch.as_tensor(x).to(mesh.device).contiguous(),
                     tree)


def replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from the mesh's rank 0,
    so every rank starts equal; returns the module."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=mesh.ranks[0], group=mesh.group)
    return module
