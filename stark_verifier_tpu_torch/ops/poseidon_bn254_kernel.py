"""The BN254 bridge permutation as a hand-written Hopper kernel.

`permute(state)` is the wrapper every transcript step, leaf hash and Merkle
compression of a bn254-config proof goes through (ops/hashers.py); it maps
int64[12, ...] Goldilocks words (any representative) to canonical
int64[12, ...]. `permute_plain(state)` is the same function in plain
PyTorch ops (ops/fr_bn254.permute12_bridge), for CPU tensors and for holding
the kernel against on the card.

The kernel, `bridge_permute12` in csrc/poseidon_bn254.cu, is an addition and
not the port of a TPU kernel: the JAX package computes this function with
plain jnp ops (stark_verifier_tpu/ops/fr_bn254_jax.py:321), no Pallas
call. A CUDA tensor launches the kernel or raises; only a CPU tensor takes
the plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import fr_bn254
from ._poseidon_bn254_constants import MDS_MATRIX, ROUND_CONSTANTS

WIDTH = 12
KERNEL = "bridge_permute12"

# Kernel launches made by `permute` since the count was last set to 0.
LAUNCHES = {KERNEL: 0}

_ready: list = []


def _words(v: int) -> list:
    """An Fr value in Montgomery form (R = 2^256) as four u64 words."""
    m = v * (1 << 256) % fr_bn254.Q
    return [(m >> (64 * k)) & ((1 << 64) - 1) for k in range(4)]


def constant_tables():
    """The kernel's round constants [68 * 5 * 4] and MDS matrix [5 * 5 * 4]
    as u64 words in Montgomery form, in the layout its __constant__ arrays
    have."""
    rc = np.array([w for v in ROUND_CONSTANTS for w in _words(v)], np.uint64)
    mds = np.array([w for v in MDS_MATRIX for w in _words(v)], np.uint64)
    return rc, mds


def _library():
    """Build (at first use) and load the kernel's library, bind its C
    signatures and upload its constants."""
    if not _ready:
        from . import cuda_build

        lib = cuda_build.load("poseidon_bn254")
        # without argtypes ctypes would pass pointers as 32-bit ints
        lib.bridge_permute12.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_longlong, ctypes.c_void_p]
        lib.bridge_permute12.restype = ctypes.c_int
        lib.bridge_set_constants.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.bridge_set_constants.restype = ctypes.c_int
        rc, mds = constant_tables()
        err = lib.bridge_set_constants(rc.ctypes.data, mds.ctypes.data)
        if err != 0:
            raise RuntimeError(f"bridge_set_constants: CUDA error {err}")
        _ready.append(lib)
    return _ready[0]


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """The bridge permutation in plain PyTorch ops, on any device."""
    return fr_bn254.permute12_bridge(state)


def permute(state: torch.Tensor) -> torch.Tensor:
    """The bridge permutation on int64[12, ...]; trailing dims are
    flattened into the kernel's lane axis."""
    if state.dtype != torch.int64:
        raise TypeError(f"permute: expected int64 bit patterns, got {state.dtype}")
    if state.dim() < 1 or state.shape[0] != WIDTH:
        raise ValueError(f"permute: expected shape [12, ...], got {tuple(state.shape)}")
    if state.device.type == "cpu":
        return permute_plain(state)
    if state.device.type != "cuda":
        raise RuntimeError(f"permute: no kernel for device {state.device}")
    if not state.is_contiguous():
        raise ValueError("permute: the state must be contiguous")
    lib = _library()
    out = torch.empty_like(state)
    # asynchronous, on PyTorch's current stream (see poseidon_kernel.permute)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bridge_permute12(state.data_ptr(), out.data_ptr(),
                                   state.numel() // WIDTH, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return out
