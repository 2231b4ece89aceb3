"""The NTT plane of csrc/ntt.cu: each ntt, intt, coset_fft, coset_ifft and
coset_lde of ops/ntt.py on a CUDA tensor in one launch of `ntt_tile` (2^bits
<= 2^TILE_BITS points), then one of `ntt_stride` for each range of up to
MAX_PASS_STAGES stages above: one up to 2^17 points, more for any larger
power of two.

`transform(x, n_out, powers, epilogue, n_inv, inv_powers)` takes int64
[..., n] (any representatives; rows read in place where the leading dims
collapse to one stride) and returns a fresh contiguous int64 [..., n_out]:
the bit-reversed radix-2 DIT transform of x's first n words a row, zero
padded to n_out, each word times powers[i] first where `powers` is given;
then the epilogue (`FORWARD`: canonical; `INVERSE`: output m from position
(n_out - m) mod n_out times n_inv, canonicalised before and after;
`INVERSE_COSET`: that times inv_powers[m], canonicalised). The words are
ops/ntt.py's plain versions' at every stage boundary.

Neither kernel replaces a TPU kernel: they are the card's counterparts of
the JAX package's host C NTT (`svt_ntt_batch`, `svt_coset_lde_batch`,
native/svt_poseidon.c:754,813) and of its XLA transform (ops/ntt_jax.py).
A CUDA tensor launches the kernels or raises; only CPU tensors take the
plain versions (ops/ntt.py decides).

`geometry(bits, rows, t)` is the launches' decomposition (tiles a block,
the stride passes' stage ranges, threads a block and rows a thread),
`copy_stages` the stages of a zero-padded input that ntt_tile makes as
copies at its load, and `schedule_ntt` restates every pass on int64
tensors with the plain field ops, index for index, so the CPU tests hold
them against the plain stage loop after each pass.
"""
from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from . import gl64, ntt_np

KERNELS = ("ntt_tile", "ntt_stride")
# log2 of a tile's positions: stages 0 .. TILE_BITS - 1 in ntt_tile, the
# rest in ntt_stride (chosen by measurement: tools/torch_ntt_alternatives.py,
# and PERF.md)
TILE_BITS = 12
SMEM_WORDS = 1 << 13          # csrc NTT_SMEM_WORDS: 64 KB a block
MAX_TILE_BITS = 13            # csrc NTT_MAX_TILE_BITS
# stages an ntt_stride launch takes at most: a thread's column of 2^5 words
# in registers (csrc NTT_MAX_PASS_STAGES), so that every transform up to
# 2^(TILE_BITS + 5) = 2^17 points makes one launch of each kernel
MAX_PASS_STAGES = 5
STRIDE_LOG_THREADS = 8        # csrc NTT_STRIDE_LOG_THREADS: 256 threads a block at most
# ntt_stride: rows a thread walks at most with its column's twiddles in
# registers, and the threads (about 2,048 on each of the H100's 132 SMs)
# and blocks (two an SM, at least 32 threads each) a launch makes at least
# where the rows and columns allow
STRIDE_ROWS = 8
FILL_THREADS = 1 << 18
FILL_BLOCKS = 264
NONE, FORWARD, INVERSE, INVERSE_COSET = range(4)   # csrc EPI_*

# Kernel launches made by the wrappers since the counts were last set to 0.
LAUNCHES = {name: 0 for name in KERNELS}


# ------------------------------------------------------------ the geometry
def geometry(bits: int, rows: int, t: int = None) -> dict:
    """The launches of one transform of 2^bits points on `rows` rows with
    tiles of 2^t: `tb` (the tile's bits, min(t, bits)), `log_group` (tiles a
    ntt_tile block, neighbours in rev(k), or rows a block when one tile is
    a row), `tile_blocks`, and `stride`, one entry an ntt_stride launch:
    stages `s0` .. `s0 + stages - 1` (the stages above tb cut into
    ceil((bits - tb) / MAX_PASS_STAGES) ranges, the longer first),
    `log_threads` (threads a block), `rows_a_thread` and `blocks`; `passes`
    counts the launches. Takes any bits."""
    t = TILE_BITS if t is None else t
    if not 1 <= t <= MAX_TILE_BITS:
        raise ValueError(f"ntt: tile bits {t} outside 1..{MAX_TILE_BITS}")
    tb = min(t, bits)
    sbits = bits - tb
    room = SMEM_WORDS.bit_length() - 1 - tb
    if sbits == 0:       # a tile is a row: as many rows a block as fit
        log_group = min(room, max(rows - 1, 0).bit_length())
    else:                # tiles of one row, neighbours in rev(k)
        log_group = min(room, sbits)
    count = -(-sbits // MAX_PASS_STAGES)
    stride, s0 = [], tb
    for i in range(count):
        stages = sbits // count + (i < sbits % count)
        cols = 1 << (bits - stages)             # a thread's column a row
        rows_a_thread = max(1, min(STRIDE_ROWS, rows, rows * cols // FILL_THREADS))
        chunks = -(-rows // rows_a_thread)
        log_threads = max(5, min(STRIDE_LOG_THREADS,
                                 (cols * chunks // FILL_BLOCKS).bit_length() - 1))
        stride.append({"s0": s0, "stages": stages, "log_threads": log_threads,
                       "rows_a_thread": rows_a_thread,
                       "blocks": -(-cols >> log_threads) * chunks})
        s0 += stages
    return {"bits": bits, "tb": tb, "log_group": log_group,
            "tile_blocks": -(-(rows << sbits) >> log_group) if rows else 0,
            "stride": stride, "passes": 1 + count}


def copy_stages(n_in: int, bits: int, tb: int) -> int:
    """The stages ntt_tile makes as copies at its load (csrc's `copies`):
    the most c <= tb with n_in <= 2^(bits - c). After the bit reversal of
    n_in words padded with 0 to 2^bits, only slots whose low c bits are 0
    hold a word, so stages 0 .. c-1 pair words with 0 and copy them."""
    c = 0
    while c < tb and n_in << (c + 1) <= 1 << bits:
        c += 1
    return c


def twiddles(bits: int) -> np.ndarray:
    """The 2^bits - 1 stage twiddles as uint64, stage s at offset 2^s - 1
    (ntt_np.stage_twiddles concatenated, svt_ntt_batch's layout)."""
    stages = ntt_np.stage_twiddles(bits)
    return np.concatenate(stages) if stages else np.zeros(1, np.uint64)


# ---------------------------------------------------------- the schedule
def _brev(v: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(v)
    for i in range(bits):
        out |= ((v >> i) & 1) << (bits - 1 - i)
    return out


def tile_pass(x, n_out: int, tw, t: int, powers=None) -> torch.Tensor:
    """ntt_tile's load and stages on int64 rows [R, n_in] -> [R, n_out] in
    position order (raw words), index for index: tile u of the block
    decomposition (its row u >> sbits, rev(k) = u mod 2^sbits) gathers
    x[j 2^sbits + rev(k)], j < 2^(tb - c) (c = copy_stages), into slots
    rev_tb(j) .. rev_tb(j) + 2^c - 1 (0 beyond n_in, times powers[idx]
    where given), runs butterfly b of stage s >= c at lo = (b >> s) << (s +
    1) + (b mod 2^s), and stores slot l at rev(k) 2^tb + l."""
    R, n_in = x.shape
    bits = n_out.bit_length() - 1
    g = geometry(bits, R, t)
    tb, sbits = g["tb"], bits - g["tb"]
    T, K = 1 << tb, 1 << sbits
    c = copy_stages(n_in, bits, tb)
    u = torch.arange(R * K)
    j = torch.arange(T >> c)
    idx = (j[None, :] << sbits) + (u[:, None] & (K - 1))        # [tiles, T / 2^c]
    rows = (u >> sbits)[:, None].expand(-1, T >> c)
    real = idx < n_in
    v = torch.zeros(R * K, T >> c, dtype=torch.int64)
    v[real] = x[rows[real], idx[real]]
    if powers is not None:
        v[real] = gl64.mul_plain(v[real], powers[idx[real]])
    sm = torch.empty(R * K, T, dtype=torch.int64)
    for copy in range(1 << c):
        sm[:, _brev(j, tb) + copy] = v
    for s in range(c, tb):
        m = 1 << s
        b = torch.arange(T // 2)
        k = b & (m - 1)
        lo = ((b >> s) << (s + 1)) + k
        a, y = sm[:, lo], gl64.mul_plain(sm[:, lo + m], tw[m - 1 + k])
        sm[:, lo], sm[:, lo + m] = gl64.add_plain(a, y), gl64.sub_plain(a, y)
    out = torch.empty(R, n_out, dtype=torch.int64)
    p = (_brev(u & (K - 1), sbits) << tb)[:, None] + torch.arange(T)[None, :]
    out[(u >> sbits)[:, None].expand(-1, T), p] = sm
    return out


def stride_pass(v, tw, s0: int, stages: int) -> torch.Tensor:
    """ntt_stride's stages s0 .. s0 + stages - 1 on [R, n] in position
    order: column (h, r), the positions h 2^(s0+L) + q 2^s0 + r (L =
    stages, q < 2^L), a transform of its own; butterfly b of stage s0 + s2
    at q = lo = (b >> s2) << (s2 + 1) + j (j = b mod 2^s2), its twiddle
    tw[2^(s0 + s2) - 1 + j 2^s0 + r]."""
    R, n = v.shape
    L, step = stages, 1 << s0
    col = v.reshape(R, n >> (s0 + L), 1 << L, step).clone()     # [R, h, q, r]
    r = torch.arange(step)
    for s2 in range(L):
        m = 1 << s2
        b = torch.arange(1 << (L - 1))
        j = b & (m - 1)
        lo = ((b >> s2) << (s2 + 1)) + j
        w = tw[(step << s2) - 1 + (j[:, None] << s0) + r[None, :]]   # [2^(L-1), 2^s0]
        a, y = col[:, :, lo], gl64.mul_plain(col[:, :, lo + m], w)
        col[:, :, lo], col[:, :, lo + m] = gl64.add_plain(a, y), gl64.sub_plain(a, y)
    return col.reshape(R, n)


def epilogue_pass(v, epilogue: int, n_inv: int = 1, inv_powers=None) -> torch.Tensor:
    """The last pass's store: canonical at position p (FORWARD), or at
    position (n - p) mod n the inverse's canonical(mul(canonical(v[p]),
    n_inv)), then times inv_powers there, canonical (INVERSE_COSET)."""
    if epilogue == FORWARD:
        return gl64.canonical(v)
    n = v.shape[-1]
    p = torch.arange(n)
    m = (n - p) & (n - 1)
    w = gl64.canonical(gl64.mul_plain(gl64.canonical(v), gl64.const(n_inv)))
    if epilogue == INVERSE_COSET:
        w = gl64.canonical(gl64.mul_plain(w, inv_powers[m]))
    out = torch.empty_like(v)
    out[:, m] = w
    return out


def schedule_ntt(x, t: int, n_out: int = None, powers=None, epilogue: int = FORWARD,
                 n_inv: int = 1, inv_powers=None) -> tuple:
    """Every pass of one transform of int64 rows [R, n_in] as the kernels
    decompose it, on CPU tensors with the plain field ops: (the raw words
    after each pass, in position order; the output)."""
    n_out = x.shape[-1] if n_out is None else n_out
    bits = n_out.bit_length() - 1
    tw = gl64.from_u64(twiddles(bits), "cpu")
    after = [tile_pass(x, n_out, tw, t, powers)]
    for p in geometry(bits, x.shape[0], t)["stride"]:
        after.append(stride_pass(after[-1], tw, p["s0"], p["stages"]))
    return after, epilogue_pass(after[-1], epilogue, n_inv, inv_powers)


# ------------------------------------------------------------ the launch
_libs: dict = {}


def _bind(lib):
    # without argtypes ctypes would pass pointers as 32-bit ints
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ntt_tile.argtypes = [p, ll, ll, ll, p, p, p, p, ctypes.c_uint64, i, i, i, ll, i, p]
    lib.ntt_tile.restype = i
    lib.ntt_stride.argtypes = [p, p, p, p, ctypes.c_uint64, i, i, i, i, i, ll, i, p]
    lib.ntt_stride.restype = i
    lib.ntt_smem_words.restype = i
    lib.ntt_max_pass_stages.restype = i
    if lib.ntt_smem_words() != SMEM_WORDS:
        raise RuntimeError(f"ntt.cu has {lib.ntt_smem_words()} words of shared memory a "
                           f"block, the wrapper plans for {SMEM_WORDS}")
    if lib.ntt_max_pass_stages() != MAX_PASS_STAGES:
        raise RuntimeError(f"ntt.cu takes {lib.ntt_max_pass_stages()} stages a stride "
                           f"pass, the wrapper plans for {MAX_PASS_STAGES}")


def _library(device: torch.device):
    """The library for a launch on `device`: built at first use, bound once
    (its tables are tensors, through gl64.table)."""
    lib = _libs.get(device.index)
    if lib is None:
        from . import cuda_build

        lib = _libs[device.index] = cuda_build.library_on("ntt", device, _bind,
                                                          lambda lib: None)
    return lib


def _stream(device: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(device.index)


def _device_of(x) -> str:
    """'cuda' for an int64 tensor on a CUDA device; raises for another
    dtype or a device with no kernel."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int64:
        raise TypeError(f"ntt kernel: expected an int64 tensor, got "
                        f"{getattr(x, 'dtype', type(x).__name__)}")
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return "cuda"


def _rows(x: torch.Tensor):
    """(x as rows [R, n] read in place where the leading dims step as one,
    row count, row stride, element stride)."""
    n = x.shape[-1]
    lead = [(x.shape[d], x.stride(d)) for d in range(x.dim() - 1) if x.shape[d] > 1]
    if any(outer[1] != inner[1] * inner[0] for outer, inner in zip(lead, lead[1:])):
        x = x.contiguous()
        lead = [(size, n) for size, _ in lead[-1:]]
    rows = x.numel() // n
    return x, rows, lead[-1][1] if lead else n, x.stride(-1)


def _on(dev: torch.device):
    """The device's context for a launch: none when it is the current one."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def plan(x: torch.Tensor, n_out: int = None, powers: torch.Tensor = None,
         epilogue: int = FORWARD, n_inv: int = 1, inv_powers: torch.Tensor = None) -> tuple:
    """The launches of one transform on the card (module docstring), not
    yet made: (the output, [(kernel name, launch)]), each launch a counted
    call on the device's current stream that raises on a CUDA error.
    `powers` int64 [n] on x's device or None, `inv_powers` int64 [n_out]
    for INVERSE_COSET; ntt_tile, then one ntt_stride a stage range of
    `geometry`, the epilogue in the last."""
    _device_of(x)
    dev = x.device
    n = x.shape[-1]
    n_out = n if n_out is None else n_out
    bits = n_out.bit_length() - 1
    if n_out != 1 << bits or n > n_out or n < 1:
        raise ValueError(f"ntt: {n} points padded to {n_out}, not a power of two above")
    xr, rows, row_stride, elem_stride = _rows(x)
    g = geometry(bits, rows)
    out = torch.empty(tuple(x.shape[:-1]) + (n_out,), dtype=torch.int64, device=dev)
    if rows == 0:
        return out, []
    tw = gl64.table(("ntt_twiddles", bits), dev, lambda: twiddles(bits))
    lib = _library(dev)
    last = len(g["stride"]) - 1
    # an inverse's last pass stores to other columns: the passes before it
    # write a buffer of their own
    mid = torch.empty_like(out) if last >= 0 and epilogue != FORWARD else out
    pw = None if powers is None else powers.data_ptr()
    ip = None if inv_powers is None else inv_powers.data_ptr()

    def tile():
        with _on(dev):
            err = lib.ntt_tile(xr.data_ptr(), row_stride, elem_stride, n, mid.data_ptr(),
                               tw.data_ptr(), pw, ip, n_inv, bits, g["tb"], g["log_group"],
                               rows, NONE if last >= 0 else epilogue, _stream(dev))
        _check(err, "ntt_tile")

    def stride(i, p):
        dst, epi = (out, epilogue) if i == last else (mid, NONE)

        def launch():
            with _on(dev):
                err = lib.ntt_stride(mid.data_ptr(), dst.data_ptr(), tw.data_ptr(), ip, n_inv,
                                     bits, p["s0"], p["stages"], p["log_threads"],
                                     p["rows_a_thread"], rows, epi, _stream(dev))
            _check(err, "ntt_stride")
        return launch

    return out, [("ntt_tile", tile)] + [("ntt_stride", stride(i, p))
                                        for i, p in enumerate(g["stride"])]


def transform(x: torch.Tensor, **kw) -> torch.Tensor:
    """One transform on the card: `plan(x, **kw)`'s launches, made."""
    out, launches = plan(x, **kw)
    for _, launch in launches:
        launch()
    return out
