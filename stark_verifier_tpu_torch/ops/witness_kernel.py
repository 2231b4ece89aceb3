"""The recursive provers' two witness kernels (csrc/witness.cu).

`poseidon_gate_fill(ins, swap)`: all 135 wires of a PoseidonGate row,
int64[12, ...] inputs and int64[...] swap bits -> int64[135, ...],
canonical, any representative accepted on input. Every PoseidonGate row of
a circuit's witness goes through it (prover/builder.poseidon_permute, by
way of core/gates.poseidon_witness_fill); its plain version is
core/gates.poseidon_fill_plain.

`ext2_reduce_chain(alpha, acc, coeffs)`: the Horner chain of a Reducing or
ReducingExtension gate row in GF(p^2), acc <- acc * alpha + c_i with
X^2 = 7: int64[2, ...] alpha and old accumulator, int64[k, 2, ...]
coefficients (component 1 zero for base ones) -> every accumulator,
int64[k, 2, ...], canonical. `ext2_reduce_chain_plain` is the same loop in
`ops/ext2` tensor ops.

Neither replaces a TPU kernel: they are the card's counterparts of the two
host C planes the JAX package's recursion prover calls
(`svt_poseidon_fill_batch`, `svt_ext2_reduce_chain`, native/svt_poseidon.c).
A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version. Trailing dims are flattened into the kernels' lane axis.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import ext2, gl64

WIDTH = 12
FILL_WIRES = 135
KERNELS = ("poseidon_gate_fill", "ext2_reduce_chain")

# Kernel launches made by the wrappers since the counts were last set to 0.
LAUNCHES = {name: 0 for name in KERNELS}

_ready: list = []


def fill_tables() -> np.ndarray:
    """u64[FILL_TABLE_WORDS] the fill kernel reads, in csrc/witness.cu's
    order: the tables `poseidon_kernel.schedule_tables()` gives (the 30 x 12
    round constants, then plonky2's forwarded partial-round constants), then
    the fast form's initial matrix (11 x 11), w-hats and vs (22 x 11 each)."""
    from ._poseidon_gl_constants import (
        FAST_PARTIAL_ROUND_INITIAL_MATRIX,
        FAST_PARTIAL_ROUND_VS,
        FAST_PARTIAL_ROUND_W_HATS,
    )
    from .poseidon_kernel import schedule_tables

    rc, partial = schedule_tables()
    sparse = np.asarray(FAST_PARTIAL_ROUND_INITIAL_MATRIX + FAST_PARTIAL_ROUND_W_HATS
                        + FAST_PARTIAL_ROUND_VS, dtype=np.uint64)
    return np.ascontiguousarray(np.concatenate([rc, partial, sparse]))


def _library():
    """Build (at first use) and load the library, bind its C signatures and
    upload the fill's tables."""
    if not _ready:
        from . import cuda_build

        lib = cuda_build.load("witness")
        # without argtypes ctypes would pass pointers as 32-bit ints
        lib.poseidon_gate_fill.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.c_void_p]
        lib.ext2_reduce_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_void_p]
        lib.witness_set_tables.argtypes = [ctypes.c_void_p]
        for fn in (lib.poseidon_gate_fill, lib.ext2_reduce_chain,
                   lib.witness_set_tables, lib.witness_table_words):
            fn.restype = ctypes.c_int
        tables = fill_tables()
        if lib.witness_table_words() != tables.size:
            raise RuntimeError(f"witness.cu expects {lib.witness_table_words()} "
                               f"table words, the wrapper has {tables.size}")
        err = lib.witness_set_tables(tables.ctypes.data)
        if err != 0:
            raise RuntimeError(f"witness_set_tables: CUDA error {err}")
        _ready.append(lib)
    return _ready[0]


def _device_of(*tensors) -> str:
    """'cpu' or 'cuda', the one device of int64 operands; raises for
    another dtype, another device, or operands on two devices."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int64:
            raise TypeError(f"expected int64 bit patterns, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {dev}")
    return dev.type


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------ poseidon_gate_fill
def poseidon_gate_fill_plain(ins: torch.Tensor, swap: torch.Tensor) -> torch.Tensor:
    """The fill in plain PyTorch ops, on any device."""
    from ..core.gates import poseidon_fill_plain

    return poseidon_fill_plain(ins, swap)


def poseidon_gate_fill(ins: torch.Tensor, swap: torch.Tensor) -> torch.Tensor:
    """int64[12, *S] inputs, int64[*S] swap bits -> int64[135, *S] wires."""
    if ins.dim() < 1 or ins.shape[0] != WIDTH or tuple(swap.shape) != tuple(ins.shape[1:]):
        raise ValueError(f"poseidon_gate_fill: expected [12, *S] and [*S], got "
                         f"{tuple(ins.shape)} and {tuple(swap.shape)}")
    if _device_of(ins, swap) == "cpu":
        return poseidon_gate_fill_plain(ins, swap)
    lanes = swap.numel()
    x = ins.reshape(WIDTH, lanes).contiguous()
    sw = swap.reshape(lanes).contiguous()
    out = torch.empty((FILL_WIRES, lanes), dtype=torch.int64, device=ins.device)
    if lanes:
        lib = _library()
        with torch.cuda.device(ins.device):
            err = lib.poseidon_gate_fill(x.data_ptr(), sw.data_ptr(), out.data_ptr(),
                                         lanes, _stream(ins.device))
        if err != 0:
            raise RuntimeError(f"poseidon_gate_fill launch failed: CUDA error {err}")
        LAUNCHES["poseidon_gate_fill"] += 1
    return out.reshape((FILL_WIRES,) + tuple(ins.shape[1:]))


# ------------------------------------------------------- ext2_reduce_chain
def ext2_reduce_chain_plain(alpha: torch.Tensor, acc: torch.Tensor,
                            coeffs: torch.Tensor) -> torch.Tensor:
    """The chain in `ops/ext2` tensor ops, on any device."""
    F = gl64.Field(alpha.device)
    a = (alpha[0], alpha[1])
    x = (acc[0], acc[1])
    out = []
    for c in coeffs:
        x = ext2.add(F, ext2.mul(F, x, a), (c[0], c[1]))
        out.append(torch.stack(x))
    if not out:
        return coeffs.clone()
    return gl64.canonical(torch.stack(out))


def ext2_reduce_chain(alpha: torch.Tensor, acc: torch.Tensor,
                      coeffs: torch.Tensor) -> torch.Tensor:
    """int64[2, *S] alpha and accumulator, int64[k, 2, *S] coefficients ->
    int64[k, 2, *S] accumulators."""
    shape = tuple(alpha.shape[1:])
    if (alpha.dim() < 1 or alpha.shape[0] != 2 or tuple(acc.shape) != tuple(alpha.shape)
            or coeffs.dim() != alpha.dim() + 1 or coeffs.shape[1] != 2
            or tuple(coeffs.shape[2:]) != shape):
        raise ValueError(f"ext2_reduce_chain: expected [2, *S], [2, *S], [k, 2, *S], "
                         f"got {tuple(alpha.shape)}, {tuple(acc.shape)}, "
                         f"{tuple(coeffs.shape)}")
    if _device_of(alpha, acc, coeffs) == "cpu":
        return ext2_reduce_chain_plain(alpha, acc, coeffs)
    k, lanes = coeffs.shape[0], int(np.prod(shape, dtype=np.int64))
    a = alpha.reshape(2, lanes).contiguous()
    x = acc.reshape(2, lanes).contiguous()
    c = coeffs.reshape(k, 2, lanes).contiguous()
    out = torch.empty((k, 2, lanes), dtype=torch.int64, device=alpha.device)
    if k and lanes:
        lib = _library()
        with torch.cuda.device(alpha.device):
            err = lib.ext2_reduce_chain(a.data_ptr(), x.data_ptr(), c.data_ptr(),
                                        out.data_ptr(), k, lanes, _stream(alpha.device))
        if err != 0:
            raise RuntimeError(f"ext2_reduce_chain launch failed: CUDA error {err}")
        LAUNCHES["ext2_reduce_chain"] += 1
    return out.reshape((k, 2) + shape)
