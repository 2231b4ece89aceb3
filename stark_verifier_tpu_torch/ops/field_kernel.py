"""The elementwise field plane of csrc/field.cu: one launch for each call
of `gl64.mul`, `add`, `sub`, `mul_add`, `mul_small` (and `neg`, `square`,
which go through `sub` and `mul`) on a CUDA tensor.

`mul(a, b)`, `add(a, b)`, `sub(a, b)`, `mul_add(a, b, c)`: int64 operands
of shapes that broadcast -> a fresh contiguous int64 tensor of the
broadcast shape. `mul_small(a, k)`: a python int 0 <= k < 2^15 -> int64 of
a's shape (k = 0 gives zeros and k = 1 the tensor `a` itself, with no
launch, as the plain version does). `neg(a)`: `gl_sub` with a null first
operand, which the kernel reads as 0. The words are the plain versions'
(`gl64.mul_plain` ... `gl64.mul_small_plain`), not canonicalised.

None replaces a TPU kernel: they are the card's counterparts of the JAX
package's elementwise host C plane (`svt_gl_mul`, `svt_gl_add_arr`,
`svt_gl_sub_arr`, `svt_gl_mul_add`, native/svt_poseidon.c:277-339) and of
the one XLA fusion its JAX field (`gl64_jax`) compiles to. A CUDA tensor
launches the kernel or raises; only CPU tensors take the plain version.
Operands on two devices, another dtype, or a python number where a tensor
is expected raise.

Operands are read where they lie: `launch_args` turns their shapes and
strides into the kernel's geometry (the broadcast shape collapsed to at
most MAX_RANK dims, each operand's strides in words, 0 on a broadcast dim),
so a broadcast or strided operand costs no copy. Where more than MAX_RANK
dims are left, `fit` first copies the operands that keep them apart
(contiguous in the broadcast shape), so any rank takes one launch; no path
of the package makes such operands. Equal shapes, contiguous, take a short
path. An empty output launches nothing.

`schedule_field_ints` restates one thread's arithmetic on python ints, and
`launch_args` is a pure function of shapes and strides, so the CPU tests
hold both against the plain versions.
"""
from __future__ import annotations

import array
import ctypes

import torch

from . import gl64

KERNELS = ("gl_mul", "gl_add", "gl_sub", "gl_mul_add", "gl_mul_small")
_OP = {name: i for i, name in enumerate(KERNELS)}   # csrc OP_MUL .. OP_MUL_SMALL
MAX_RANK = 6                                        # csrc FIELD_MAX_RANK
GEOM_WORDS = 2 + MAX_RANK + 3 * MAX_RANK            # csrc FIELD_GEOM_WORDS
_PAD = [0] * MAX_RANK
_ONES = [1] * MAX_RANK

# Kernel launches made by the wrappers since the counts were last set to 0.
LAUNCHES = {name: 0 for name in KERNELS}


# ------------------------------------------------------------ the geometry
def launch_args(*operands) -> tuple:
    """(shape, geom) of one launch over up to three operands (tensors, or
    None for gl64.neg's zero, read as a 0-dim operand): the output's
    broadcast shape, and the GEOM_WORDS words `field_launch` reads: [n,
    rank, shape (MAX_RANK), strides of operands 0, 1, 2 (MAX_RANK each)],
    outer dim first, in words. Dims of size 1 are dropped and neighbours
    every operand steps through as one are merged; strides of an absent
    operand are 0. Raises ValueError for shapes that do not broadcast or
    more than MAX_RANK dims after the merge (`fit` makes those one dim)."""
    shape, geom = _geometry(operands)
    if geom is None:
        raise ValueError(f"field kernel: more than {MAX_RANK} dims after merging "
                         f"({_shapes(operands)})")
    return shape, geom


def _geometry(operands) -> tuple:
    """launch_args' (shape, geom), with geom None for more than MAX_RANK
    dims after the merge."""
    first = operands[0]
    if first is not None:
        shape = first.shape
        if all(t is not None and t.shape == shape and t.is_contiguous() for t in operands):
            n = first.numel()
            strides = ([1] + _PAD[1:]) * len(operands) + _PAD * (3 - len(operands))
            return shape, [n, 1, n] + _ONES[1:] + strides
    shape, aligned = _broadcast(operands)
    n = shape.numel()
    if n == 0:
        return shape, [0, 1] + _ONES + _PAD * 3
    dims = _merged(shape, aligned)
    if len(dims) > MAX_RANK:
        return shape, None
    dims.reverse()
    rank = len(dims)
    geom = [n, rank] + [size for size, _ in dims] + _ONES[rank:]
    for j in range(3):
        geom += ([st[j] for _, st in dims] + [0] * (MAX_RANK - rank)
                 if j < len(operands) else _PAD)
    return shape, geom


def fit(operands) -> tuple:
    """The operands as one launch takes them where more than MAX_RANK dims
    are left after merging: each operand whose own strides keep two dims
    of the broadcast shape apart made contiguous in that shape
    (`t.expand(shape).contiguous()`), so that all the dims merge into one;
    the others (contiguous ones of that shape, 0-dim ones, None) as they
    are. Raises ValueError for shapes that do not broadcast."""
    shape, aligned = _broadcast(operands)
    return tuple(t if t is None or len(_merged(shape, [st])) == 1
                 else t.expand(shape).contiguous() for t, st in zip(operands, aligned))


def _shapes(operands) -> list:
    return [() if t is None else tuple(t.shape) for t in operands]


def _broadcast(operands) -> tuple:
    """(the broadcast shape, each operand's strides over its dims: 0 where
    it broadcasts). Raises ValueError for shapes that do not broadcast."""
    shapes = _shapes(operands)
    nd = max(len(sh) for sh in shapes)
    shape = [1] * nd
    for sh in shapes:
        for d, size in enumerate(sh, nd - len(sh)):
            if size != 1:
                if shape[d] not in (1, size):
                    raise ValueError(f"field kernel: operands of shapes {shapes} do not "
                                     f"broadcast")
                shape[d] = size
    aligned = []
    for t, sh in zip(operands, shapes):
        st = [0] * nd
        if t is not None:
            for d, (size, step) in enumerate(zip(sh, t.stride()), nd - len(sh)):
                if size != 1:
                    st[d] = step
        aligned.append(st)
    return torch.Size(shape), aligned


def _merged(shape, aligned) -> list:
    """[size, strides] of the dims left, innermost first: size-1 dims
    dropped, a dim merged into the next inner one where every operand
    steps through the two as one."""
    dims = []
    for d in reversed(range(len(shape))):
        size = shape[d]
        if size == 1:
            continue
        st = [a[d] for a in aligned]
        if dims and all(s == inner * dims[-1][0] for s, inner in zip(st, dims[-1][1])):
            dims[-1][0] *= size      # steps on from the inner dim: one dim
        else:
            dims.append([size, st])
    return dims or [[1, [0] * len(aligned)]]


# ---------------------------------------------------------- the schedule
def _sub_ints(x: int, y: int) -> int:
    """goldilocks.cuh sub_gl: the wrap below 0 folded as -EPS, which can wrap
    once more."""
    from .poseidon_kernel import _EPS, _U64

    d1 = (x - y) & _U64
    d2 = (d1 - _EPS) & _U64 if x < y else d1
    return (d2 - _EPS) & _U64 if x < y and d1 < _EPS else d2


def schedule_field_ints(name: str, x: int, y: int = 0, z: int = 0, k: int = 0) -> int:
    """One element of kernel `name` (`KERNELS`) as a thread of field.cu
    computes it, on python ints below 2^64: x, y, z the words it read of
    operands 0, 1, 2 (0 for a null operand), k mul_small's constant
    (goldilocks.cuh's mul_gl and add_gl, as the other kernels' schedules
    restate them)."""
    from .poseidon_kernel import _mul_gl
    from .witness_kernel import _add_gl

    x, y, z = int(x), int(y), int(z)
    if name == "gl_mul":
        return _mul_gl(x, y)
    if name == "gl_add":
        return _add_gl(x, y)
    if name == "gl_sub":
        return _sub_ints(x, y)
    if name == "gl_mul_add":
        return _add_gl(_mul_gl(x, y), z)
    if name == "gl_mul_small":
        return _mul_gl(x, int(k))
    raise ValueError(f"no field kernel {name!r}")


# ------------------------------------------------------------ the launch
_libs: dict = {}


def _bind(lib):
    # without argtypes ctypes would pass pointers as 32-bit ints
    lib.field_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_void_p, ctypes.c_void_p]
    lib.field_launch.restype = ctypes.c_int
    lib.field_geom_words.restype = ctypes.c_int
    if lib.field_geom_words() != GEOM_WORDS:
        raise RuntimeError(f"field.cu reads {lib.field_geom_words()} geometry words, "
                           f"the wrapper writes {GEOM_WORDS}")


def _library(device: torch.device):
    """The library for a launch on `device`: built at first use, bound once
    (no tables to upload)."""
    lib = _libs.get(device.index)
    if lib is None:
        from . import cuda_build

        lib = _libs[device.index] = cuda_build.library_on("field", device, _bind,
                                                          lambda lib: None)
    return lib


def _stream(device: torch.device) -> int:
    """The device's current stream, as `torch.cuda.current_stream(device).
    cuda_stream` gives it, without making a Stream object: a launch's host
    time is the wrapper's."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _device_of(operands) -> str:
    """'cpu' or 'cuda', the one device of the operands (tensors, None
    allowed); raises for a non-tensor, another dtype, operands on two
    devices, or a device with no kernel."""
    dev = None
    for t in operands:
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"field kernel: expected int64 tensors, got {type(t).__name__}")
        if t.dtype != torch.int64:
            raise TypeError(f"field kernel: expected int64 bit patterns, got {t.dtype}")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"field kernel: operands on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {dev}")
    return dev.type


def _launch(name: str, operands: tuple, k: int = 0) -> torch.Tensor:
    """One counted launch of kernel `name` over `operands` (checked by
    `_device_of`, on a CUDA device; through `fit` where they keep more than
    MAX_RANK dims) on the device's current stream; a CUDA error raises."""
    dev = (operands[0] if operands[0] is not None else operands[1]).device
    shape, geom = _geometry(operands)
    if geom is None:            # more than MAX_RANK dims: copy what keeps them apart
        operands = fit(operands)
        shape, geom = _geometry(operands)
    out = torch.empty(shape, dtype=torch.int64, device=dev)
    if geom[0]:
        ptrs = [None if t is None else t.data_ptr() for t in operands]
        ptrs += [None] * (3 - len(ptrs))
        lib = _library(dev)
        words = array.array("q", geom)    # read by the C side before it returns
        args = (_OP[name], *ptrs, out.data_ptr(), k, words.buffer_info()[0])
        if dev.index == torch.cuda.current_device():
            err = lib.field_launch(*args, _stream(dev))
        else:
            with torch.cuda.device(dev):
                err = lib.field_launch(*args, _stream(dev))
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------- the wrappers
def mul(a, b):
    """a * b: `gl_mul`, or `gl64.mul_plain` on CPU tensors."""
    if _device_of((a, b)) == "cpu":
        return gl64.mul_plain(a, b)
    return _launch("gl_mul", (a, b))


def add(a, b):
    """a + b: `gl_add`, or `gl64.add_plain` on CPU tensors."""
    if _device_of((a, b)) == "cpu":
        return gl64.add_plain(a, b)
    return _launch("gl_add", (a, b))


def sub(a, b):
    """a - b: `gl_sub`, or `gl64.sub_plain` on CPU tensors."""
    if _device_of((a, b)) == "cpu":
        return gl64.sub_plain(a, b)
    return _launch("gl_sub", (a, b))


def neg(a):
    """0 - a: `gl_sub` with a null first operand, or `gl64.sub_plain` of
    zeros on CPU tensors."""
    if _device_of((a,)) == "cpu":
        return gl64.sub_plain(torch.zeros_like(a), a)
    return _launch("gl_sub", (None, a))


def mul_add(a, b, c):
    """a * b + c: `gl_mul_add`, or `gl64.mul_add_plain` on CPU tensors."""
    if _device_of((a, b, c)) == "cpu":
        return gl64.mul_add_plain(a, b, c)
    return _launch("gl_mul_add", (a, b, c))


def mul_small(a, k: int):
    """a * k for a python int 0 <= k < 2^15: `gl_mul_small`, or
    `gl64.mul_small_plain` on CPU tensors; k = 0 and 1 launch nothing."""
    if not 0 <= k < (1 << 15):
        raise ValueError(f"mul_small: k = {k} is not below 2^15")
    if _device_of((a,)) == "cpu":
        return gl64.mul_small_plain(a, k)
    if k == 0:
        return torch.zeros_like(a)
    if k == 1:
        return a
    return _launch("gl_mul_small", (a,), int(k))
