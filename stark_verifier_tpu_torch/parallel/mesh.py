"""The data mesh: a one-dimensional `DeviceMesh` over the ranks of the
process group, and the placement of a proof batch on it.

A batch is a dict (or list, tuple) of uint64 numpy arrays with a leading
batch axis, as `models/flagship.batched_arrays` makes it. `shard_batch`
gives this rank its contiguous slice (`multihost.host_batch_slice`) as int64
tensors on this rank's device; `replicate` gives every rank the whole.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import gl64
from .multihost import host_batch_slice


def make_mesh(n_devices: int = None, axis: str = "data") -> DeviceMesh:
    """A mesh with the one dimension `axis` over the initialised world; its
    device type follows the backend (nccl -> cuda, else cpu). `n_devices`,
    if given, must be the world size: every rank takes part."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: init_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                         f"the world has {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world), mesh_dim_names=(axis,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _batch_size(tree):
    if isinstance(tree, dict):
        return _batch_size(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _batch_size(tree[0])
    return tree.shape[0]


def shard_batch(mesh: DeviceMesh, tree, axis: str = "data"):
    """This rank's contiguous slice of the leading batch axis, on its
    device."""
    group = mesh.get_group(axis)
    lo, hi = host_batch_slice(_batch_size(tree), dist.get_rank(group),
                              dist.get_world_size(group))
    device = mesh_device(mesh)
    return _map(tree, lambda a: gl64.from_u64(a[lo:hi], device))


def replicate(mesh: DeviceMesh, tree):
    """The whole tree on this rank's device."""
    device = mesh_device(mesh)
    return _map(tree, lambda a: gl64.from_u64(a, device))
