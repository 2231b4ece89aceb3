"""The flagship pipeline: batched Semaphore-proof verification on the GPU.

Loads a batch of Semaphore proofs from a fixture (core/types.load_proofs),
stacks them along a leading batch axis, and exposes the verifier over int64
tensors on a device: batch-in-lanes (`make_verifier_fn_batched`, the unit
of throughput) or proof by proof (`make_verifier_fn`, and
`make_verifier_fn_phased`, which runs the three protocol phases apart).
All three take the same batched dict and return the accept bits bool[B];
chip_smoke.py drives them.
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


def _bind(common, vk, device):
    """(F, vk_cap, digest, to_device) on `device`: what every entry point
    below closes over."""
    F = gl64.Field(_require_device(device))
    vk_cap = F.from_u64(vk.constants_sigmas_cap)
    digest = F.from_u64(vk.circuit_digest)

    def to_device(batched):
        return {k: F.from_u64(v) for k, v in batched.items()}

    return F, vk_cap, digest, to_device


def _one_by_one(verify_one):
    """Lift a per-proof verifier to the batched dict: proof b is the b-th
    slice of every array; the accept bits are stacked to bool[B]."""
    def fn(pa):
        n = pa["public_inputs"].shape[0]
        return torch.stack(
            [verify_one({k: v[b] for k, v in pa.items()}) for b in range(n)])

    return fn


def make_verifier_fn(common, vk, device="cuda", permute=None,
                     inner_permute=None):
    """Per-proof verifier (core/verifier.verify) on `device`, proofs verified
    one by one: where the JAX package maps its single-proof verifier over
    the batch, this loops. Returns (fn, to_device) as
    make_verifier_fn_batched does. A proof's Poseidon calls have 1, Q and
    4 * Q lanes (Q = number of FRI queries)."""
    F, vk_cap, digest, to_device = _bind(common, vk, device)
    return _one_by_one(
        lambda pa: V.verify(F, common, vk_cap, digest, pa, permute=permute,
                            inner_permute=inner_permute)
    ), to_device


def make_verifier_fn_phased(common, vk, device="cuda", permute=None,
                            inner_permute=None):
    """The per-proof verifier as its three phases (challenges, vanishing
    polynomial, FRI) run in sequence; the challenges cross the phase
    boundaries as a plain dict. Same result as make_verifier_fn."""
    F, vk_cap, digest, to_device = _bind(common, vk, device)

    def verify_one(pa):
        pi_hash, ch = V.phase_challenges(F, common, digest, pa, permute=permute,
                                         inner_permute=inner_permute)
        ok = V.phase_vanishing(F, common, pa, pi_hash, ch)
        return V.phase_fri(F, common, vk_cap, pa, ch, ok, permute=permute)

    return _one_by_one(verify_one), to_device


def make_verifier_fn_batched(common, vk, device="cuda", permute=None,
                             inner_permute=None):
    """Batch-in-lanes verifier (core/verifier_batched.py) on `device`.

    Returns (fn, to_device): `to_device` maps the u64 numpy dict of
    `batched_arrays` to int64 tensors on the device, `fn` maps those to the
    accept bits bool[B]. `permute` overrides the transcript and Merkle
    permutation, `inner_permute` the public-input hash's (see
    core/verifier.py), e.g. `functools.partial(poseidon_gl.permute, mxu=1)`
    for a kernel variant. By default the transcript follows the circuit's
    hash config (Goldilocks Poseidon, or the BN254 bridge under "bn254"),
    the public-input hash is Goldilocks Poseidon, and on a CUDA device each
    launches its Hopper kernel (SVT_POSEIDON_MXU names the Poseidon one)."""
    F, vk_cap, digest, to_device = _bind(common, vk, device)

    def fn(pa):
        return VB.verify_batched(F, common, vk_cap, digest, pa, permute=permute,
                                 inner_permute=inner_permute)

    return fn, to_device
