"""State carried across from the JAX package.

A verifier has no weights; its state is the circuit description, the
verifying key and the proof arrays. `from_reference` takes them in the
forms the JAX package produces (its `CommonData.to_json()`, the verifying
key's two uint64 arrays, and the uint64 dict of its
`models.flagship.batched_arrays`) and returns the port's own objects on a
device; `to_u64_numpy` goes back. Gates cross as their id strings inside
the JSON, never as objects.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.types import CommonData, VerifierOnlyData
from .ops import gl64


def from_reference(common_json: str, vk_cap: np.ndarray, vk_digest: np.ndarray,
                   batched: dict, device):
    """-> (CommonData, VerifierOnlyData, vk_cap tensor, vk_digest tensor,
    dict[str, int64 tensor]) with the tensors on `device`."""
    common = CommonData.from_json(common_json)
    common.gates  # resolves every gate id now: an unported gate raises here
    vk = VerifierOnlyData(np.asarray(vk_cap, np.uint64),
                          np.asarray(vk_digest, np.uint64))
    device = torch.device(device)
    pa = {k: gl64.from_u64(v, device) for k, v in batched.items()}
    return (common, vk, gl64.from_u64(vk.constants_sigmas_cap, device),
            gl64.from_u64(vk.circuit_digest, device), pa)


def to_u64_numpy(x):
    """int64 tensor (or a dict/list/tuple of them) -> canonical uint64 numpy."""
    if isinstance(x, dict):
        return {k: to_u64_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_u64_numpy(v) for v in x)
    return gl64.to_u64(x)
