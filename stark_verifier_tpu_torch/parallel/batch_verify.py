"""Multi-rank batched verification: every rank verifies its contiguous slice
of the proof batch, and the ranks reduce an accept count and a Poseidon
digest of what each verified.

The digest is the aggregation tree's analogue, one leaf a proof: a
sequential fold of `public_inputs ‖ accept ‖ acc` over the rank's rows,
with Goldilocks Poseidon whatever hash the circuit's transcript uses. The
per-rank digests travel by `all_gather` as int64 bit patterns, unchanged;
only the accept count goes through `all_reduce(SUM)`. A rank whose slice is
empty joins every collective with the zero digest and a count of 0, and
does not call the verifier.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import verifier as V
from ..core import verifier_batched as VB
from ..core.types import CommonData
from ..models import flagship as FS
from ..ops import poseidon_gl as pg
from .mesh import shard_batch


def digest_chain(F, pis, ok, permute=pg.permute):
    """Fold the local rows: acc <- hash_no_pad(pis[b] ‖ (ok[b] ? 1 : 0) ‖ acc)
    from acc = 0^4, one row after the other. pis: int64 [b, npi]; ok: bool
    [b]. Returns int64 [4] (canonical). `permute` is Goldilocks Poseidon (a
    kernel on CUDA, the plain version on the CPU); a row of n inputs costs
    ceil((n + 5) / 8) permutations of one lane."""
    npi = pis.shape[1]
    one, zero = F.ones(()), F.zeros(())
    acc = [F.zeros(()) for _ in range(4)]
    for b in range(pis.shape[0]):
        inputs = ([pis[b, i] for i in range(npi)]
                  + [F.select(ok[b], one, zero)] + acc)
        acc = pg.hash_no_pad(F, inputs, permute=permute)
    return F.stack(acc)


def _check_device(mesh, device):
    device = FS._require_device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"device {device} on a mesh of {mesh.device_type} ranks")
    return device


def make_sharded_verifier(common: CommonData, vk, mesh, axis: str = "data",
                          device="cuda", batched: bool = False, permute=None,
                          inner_permute=None):
    """Data-parallel verification over `mesh[axis]`. Returns
    (shard, verify_fn, agg_fn):
        shard     - batched uint64 dict (the whole batch) -> this rank's
                    slice as int64 tensors on its device
        verify_fn - local slice -> accept bool [b]: the batch-in-lanes
                    verifier when `batched`, else proof by proof
        agg_fn    - (public_inputs int64 [b, npi], ok bool [b]) ->
                    (per-rank digests int64 [world, 4], global accept count)
    `permute` / `inner_permute` go to the verifier (core/verifier.py); the
    digest chain always hashes with Goldilocks Poseidon."""
    device = _check_device(mesh, device)
    F, vk_cap, digest, _ = FS._bind(common, vk, device)
    group = mesh.get_group(axis)
    world = dist.get_world_size(group)

    def shard(tree):
        return shard_batch(mesh, tree, axis)

    if batched:
        def verify_local(pa):
            return VB.verify_batched(F, common, vk_cap, digest, pa, permute=permute,
                                     inner_permute=inner_permute)
    else:
        verify_local = FS._one_by_one(
            lambda pa: V.verify(F, common, vk_cap, digest, pa, permute=permute,
                                inner_permute=inner_permute))

    def verify_fn(pa):
        if pa["public_inputs"].shape[0] == 0:
            return torch.zeros(0, dtype=torch.bool, device=device)
        return verify_local(pa)

    def agg_fn(pis, ok):
        local = digest_chain(F, pis, ok)
        gathered = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(gathered, local, group=group)
        count = ok.sum().to(torch.int64).reshape(1)
        dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
        return torch.stack(gathered), int(count.item())

    return shard, verify_fn, agg_fn


def make_batch_verifier(common: CommonData, vk, mesh, axis: str = "data",
                        device="cuda"):
    """The per-proof verifier over the mesh in one call: this rank's slice
    pa_local -> (accept bool [b], per-rank digests int64 [world, 4], global
    accept count)."""
    _, verify_fn, agg_fn = make_sharded_verifier(common, vk, mesh, axis, device)

    def fn(pa_local):
        ok = verify_fn(pa_local)
        digests, count = agg_fn(pa_local["public_inputs"], ok)
        return ok, digests, count

    return fn
