"""The flagship pipeline: batched Semaphore-proof verification on the GPU.

Loads a batch of Semaphore proofs from a fixture (core/types.load_proofs),
stacks them along a leading batch axis, and exposes the batched verifier
over int64 tensors on a device: the unit that chip_smoke.py drives.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import verifier as V
from ..core import verifier_batched as VB
from ..core.types import CircuitConfig, FriConfig
from ..ops import gl64


def small_config() -> CircuitConfig:
    """Small preset for smoke paths."""
    return CircuitConfig(
        fri_config=FriConfig(rate_bits=3, cap_height=1, proof_of_work_bits=8,
                             num_query_rounds=4)
    )


def bench_config() -> CircuitConfig:
    """The headline Semaphore FRI parameters (plonky2_semaphore's access
    set): blowup 8, 28 queries, 16 PoW bits, cap height 4."""
    return CircuitConfig(
        fri_config=FriConfig(rate_bits=3, cap_height=4, proof_of_work_bits=16,
                             num_query_rounds=28)
    )


def batched_arrays(proofs) -> dict:
    """Stack per-proof arrays along a leading batch axis (u64 numpy)."""
    pas = [V.proof_to_arrays(p) for p in proofs]
    return {k: np.stack([pa[k] for pa in pas]) for k in pas[0]}


def _require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return device


def make_verifier_fn_batched(common, vk, device="cuda", permute=None):
    """Batch-in-lanes verifier (core/verifier_batched.py) on `device`.

    Returns (fn, to_device): `to_device` maps the u64 numpy dict of
    `batched_arrays` to int64 tensors on the device, `fn` maps those to the
    accept bits bool[B]. `permute` overrides the Poseidon permutation (see
    verify_batched); the default launches the Hopper kernel on a CUDA
    device."""
    device = _require_device(device)
    F = gl64.Field(device)
    vk_cap = F.from_u64(vk.constants_sigmas_cap)
    digest = F.from_u64(vk.circuit_digest)

    def fn(pa):
        return VB.verify_batched(F, common, vk_cap, digest, pa, permute=permute)

    def to_device(batched):
        return {k: F.from_u64(v) for k, v in batched.items()}

    return fn, to_device
