"""Multi-process wiring: `torch.distributed` init and the batch split.

Every rank is one process. The ranks meet at a rendezvous named by the
caller (`tcp://host:port` or `file:///path`), or by the environment
torch's launchers set (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK). The
backend follows the device the caller picked: NCCL for ranks on CUDA, gloo
on the CPU; nothing switches device on its own.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


# how long a rank waits at the rendezvous or in a collective before it fails
TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(coordinator: str = None, num_processes: int = None,
                     process_id: int = None, device="cuda") -> bool:
    """Join the process group. `coordinator` is an init method
    (`tcp://host:port`, `file:///path`); without one it is read as
    `tcp://$MASTER_ADDR:$MASTER_PORT`. The count and the rank come from the
    arguments, else from WORLD_SIZE / RANK (default 1 and 0); rank 0 given
    explicitly is rank 0. Returns False, and does nothing, when there is no
    coordinator. `device` picks the backend: "cuda" -> nccl (one card a
    rank, `torch.cuda.set_device(rank % cards)`), "cpu" -> gloo."""
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device 'cuda' was asked for "
                               "and no CUDA device is available")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: no backend for device {device}")
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return True


def rank_and_world():
    """(rank, world size) of this process: (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_data_mesh(axis: str = "data"):
    """One data axis over every rank of the process group."""
    from .mesh import make_mesh

    return make_mesh(axis=axis)


def host_batch_slice(global_batch: int, rank: int = None, world: int = None):
    """[start, end) of the proof batch this rank verifies: `ceil(B / n)` a
    rank, the last ones short. Where B is small the last ranks get an empty
    slice, written as the inverted pair the formula gives (B = 5, n = 4:
    rank 3 gets (6, 5)); `range(start, end)` and `a[start:end]` are empty
    for it. `rank` and `world` default to this process's."""
    r, n = rank_and_world()
    rank = r if rank is None else rank
    world = n if world is None else world
    per = (global_batch + world - 1) // world
    return rank * per, min((rank + 1) * per, global_batch)
