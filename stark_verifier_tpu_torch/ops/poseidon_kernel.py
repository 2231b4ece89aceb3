"""The Poseidon permutation over Goldilocks as a hand-written Hopper kernel.

`permute(state)` is the wrapper every sponge absorb, Fiat-Shamir duplex step
and Merkle compression of the verifier goes through; `permute_plain(state)`
is the same function in plain PyTorch ops, for CPU tensors and for holding
the kernel against on the card.

Replaces the TPU kernel `poseidon_permute_batch` (its pure vector-unit body
`_kernel`) of stark_verifier_tpu/ops/pallas/poseidon_kernel.py, reached there
through `permute_gf`. On the H100 the kernel is bound by integer operations,
not bytes: 192 bytes a permutation against some 25,000 32-bit integer
instructions. The design answers with one thread per permutation, the state
in registers, native 64-bit multiplies with one Goldilocks fold each, and an
MDS layer accumulated on 32-bit halves (see csrc/poseidon_gl.cu). The TPU's
128-lane tiling rule is not carried over: a masked tail lets every lane
count, the transcript's [12, B] calls included, use the kernel.

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import gl64

WIDTH = 12

# Kernel launches made by `permute` since the counter was last set to 0.
LAUNCHES = 0

_lib = None


def _library():
    """Build (at first use) and load the kernel's library, bind its C
    signatures and upload the round constants."""
    global _lib
    if _lib is None:
        from . import cuda_build

        lib = cuda_build.load("poseidon_gl")
        # without argtypes ctypes would pass pointers as 32-bit ints
        lib.poseidon_set_round_constants.argtypes = [ctypes.c_void_p]
        lib.poseidon_set_round_constants.restype = ctypes.c_int
        lib.poseidon_permute.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.poseidon_permute.restype = ctypes.c_int
        rc = np.ascontiguousarray(gl64._round_constants())
        err = lib.poseidon_set_round_constants(rc.ctypes.data)
        if err != 0:
            raise RuntimeError(f"poseidon_set_round_constants: CUDA error {err}")
        _lib = lib
    return _lib


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation on int64[12, ...] in plain PyTorch ops (any
    device); canonical output."""
    return gl64.permute12(state)


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation on int64[12, ...] -> int64[12, ...], canonical
    output, any representative accepted on input. Trailing dims are
    flattened into the kernel's lane axis."""
    global LAUNCHES
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
    lanes = state.numel() // WIDTH
    out = torch.empty_like(state)
    # The launch is asynchronous, on PyTorch's current stream: if the caller
    # drops `state` right away, the caching allocator hands its memory only
    # to later work on the same stream, which runs after the kernel.
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.poseidon_permute(state.data_ptr(), out.data_ptr(), lanes, stream)
    if err != 0:
        raise RuntimeError(f"poseidon_permute launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
