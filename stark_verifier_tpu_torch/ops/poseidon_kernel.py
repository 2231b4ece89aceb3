"""The Poseidon permutation over Goldilocks as hand-written Hopper kernels.

`permute(state, mxu=None)` is the wrapper every sponge absorb, Fiat-Shamir
duplex step and Merkle compression of the verifier goes through;
`permute_plain(state, mxu=0)` is the same function in plain PyTorch ops, for
CPU tensors and for holding the kernels against on the card.

Three kernels compute the one function, chosen by `mxu` as in the TPU
launcher `poseidon_permute_batch` of
stark_verifier_tpu/ops/pallas/poseidon_kernel.py, which they replace:

  mxu  kernel                  TPU body       MDS layer
  0    poseidon_permute        `_kernel`      integer pipe, 32-bit halves
  1    poseidon_permute_mma    `_kernel_mxu`  tensor cores, u8 mma on bytes
  2    poseidon_permute_mma2   `_kernel_mxu2` the same, two streams a thread

On the H100 all three are bound by integer operations, not bytes (192 bytes
a permutation against some 25,000 32-bit integer instructions); see
csrc/poseidon_gl.cu and csrc/poseidon_gl_mma.cu for what each design does
about it. The TPU's tiling rules (128 lanes, 256 for two streams) are not
carried over: a masked tail lets every lane count, the transcript's [12, B]
calls and a single proof's 1, 28 and 112 lanes included, use every kernel.

`mxu=None` reads the environment variable SVT_POSEIDON_MXU (default 0).

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import gl64

WIDTH = 12

# kernel name by `mxu`
KERNELS = ("poseidon_permute", "poseidon_permute_mma", "poseidon_permute_mma2")

# Kernel launches made by `permute` since a count was last set to 0, by kernel.
LAUNCHES = {name: 0 for name in KERNELS}

# library and the C name of its round-constant upload, by kernel
_HOME = {
    "poseidon_permute": ("poseidon_gl", "poseidon_set_round_constants"),
    "poseidon_permute_mma": ("poseidon_gl_mma", "poseidon_mma_set_round_constants"),
    "poseidon_permute_mma2": ("poseidon_gl_mma", "poseidon_mma_set_round_constants"),
}
_ready: dict[str, ctypes.CDLL] = {}


def _use_mxu() -> int:
    """0 = integer-pipe MDS, 1 = tensor-core MDS, 2 = tensor-core MDS with
    two interleaved streams. Default 0: on the H100 the tensor-core variant
    is 13 % faster at 114,688 lanes but only 1 % at 28,672, and a change of
    default was held to more than 5 % at both (PERF.md). SVT_POSEIDON_MXU
    overrides."""
    return int(os.environ.get("SVT_POSEIDON_MXU", "0") or 0)


def _library(name: str):
    """Build (at first use) and load the library `name`, bind its C
    signatures and upload the round constants (constant memory is per
    library)."""
    lib = _ready.get(name)
    if lib is None:
        from . import cuda_build

        lib = cuda_build.load(name)
        for kernel, (home, setter) in _HOME.items():
            if home != name:
                continue
            # without argtypes ctypes would pass pointers as 32-bit ints
            fn = getattr(lib, kernel)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            upload = getattr(lib, setter)
            upload.argtypes = [ctypes.c_void_p]
            upload.restype = ctypes.c_int
        rc = np.ascontiguousarray(gl64._round_constants())
        err = upload(rc.ctypes.data)
        if err != 0:
            raise RuntimeError(f"{setter}: CUDA error {err}")
        _ready[name] = lib
    return lib


def _check_mxu(mxu) -> int:
    mxu = _use_mxu() if mxu is None else mxu
    if mxu not in (0, 1, 2):
        raise ValueError(f"permute: mxu must be 0, 1 or 2, got {mxu!r}")
    return int(mxu)


def permute_plain(state: torch.Tensor, mxu: int = 0) -> torch.Tensor:
    """Poseidon permutation on int64[12, ...] in plain PyTorch ops (any
    device); canonical output. `mxu` picks the arithmetic of the kernel it
    stands beside: 0 the MDS on 32-bit halves, 1 the MDS as a product over
    bytes, 2 the same with the lanes' two halves permuted apart and joined."""
    mxu = _check_mxu(mxu)
    if mxu == 0:
        return gl64.permute12(state)
    if mxu == 1:
        return gl64.permute12(state, mds=gl64.mds12_bytes)
    flat = state.reshape(WIDTH, -1)
    half = flat.shape[1] // 2
    halves = [gl64.permute12(part, mds=gl64.mds12_bytes)
              for part in (flat[:, :half], flat[:, half:])]
    return torch.cat(halves, dim=1).reshape(state.shape)


def permute(state: torch.Tensor, mxu=None) -> torch.Tensor:
    """Poseidon permutation on int64[12, ...] -> int64[12, ...], canonical
    output, any representative accepted on input. Trailing dims are
    flattened into the kernel's lane axis. `mxu` in {0, 1, 2} picks the
    kernel; None reads SVT_POSEIDON_MXU."""
    mxu = _check_mxu(mxu)
    if state.dtype != torch.int64:
        raise TypeError(f"permute: expected int64 bit patterns, got {state.dtype}")
    if state.dim() < 1 or state.shape[0] != WIDTH:
        raise ValueError(f"permute: expected shape [12, ...], got {tuple(state.shape)}")
    if state.device.type == "cpu":
        return permute_plain(state, mxu)
    if state.device.type != "cuda":
        raise RuntimeError(f"permute: no kernel for device {state.device}")
    if not state.is_contiguous():
        raise ValueError("permute: the state must be contiguous")
    kernel = KERNELS[mxu]
    launch = getattr(_library(_HOME[kernel][0]), kernel)
    lanes = state.numel() // WIDTH
    out = torch.empty_like(state)
    # The launch is asynchronous, on PyTorch's current stream: if the caller
    # drops `state` right away, the caching allocator hands its memory only
    # to later work on the same stream, which runs after the kernel.
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(state.data_ptr(), out.data_ptr(), lanes, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
    return out
