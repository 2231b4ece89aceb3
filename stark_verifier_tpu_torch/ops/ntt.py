"""Radix-2 NTT / coset LDE over Goldilocks on int64 tensors (ops/gl64), on
the device of the input.

`ntt` is the local batched transform: batch axes lead, the transform axis is
last. On a CUDA tensor `ntt`, `intt`, `coset_fft`, `coset_ifft` and
`coset_lde` each launch ntt_tile, and above 2^TILE_BITS points one
ntt_stride a range of stages (ops/ntt_kernel.py, csrc/ntt.cu), or raise;
on a CPU tensor they run their `*_plain` versions, each stage one
vectorised butterfly over the whole tensor. Both give the same words at every stage boundary. `ntt_4step`
splits the transform axis over the ranks of a mesh: a column DFT across
ranks between two `all_to_all` exchanges, a twiddle scaling, a local row
NTT, and a third exchange back to natural order. Outputs are canonical and
equal, word for word, to the numpy oracle (ops/ntt_np.py).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import gl64
from . import ntt_kernel as NK
from . import ntt_np
from ..utils.bits import log2_strict, reverse_index_bits_perm

P = gl64.P

_cache: dict = {}


def _cached(key, make):
    if key not in _cache:
        _cache[key] = make()
    return _cache[key]


def _stage_twiddles(bits: int, device):
    return _cached(("stages", bits, str(device)), lambda: [
        gl64.from_u64(t, device) for t in ntt_np.stage_twiddles(bits)])


def _bitrev(n: int, device):
    return _cached(("bitrev", n, str(device)), lambda: torch.from_numpy(
        reverse_index_bits_perm(n).astype(np.int64)).to(device))


def _powers(base: int, n: int, device):
    return _cached(("powers", base, n, str(device)),
                   lambda: gl64.from_u64(ntt_np.powers(base, n), device))


def _on_card(x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain versions); True for any other,
    whose launch runs the kernels or raises."""
    return not x.is_cpu


def ntt_stages_plain(x: torch.Tensor, stages: int) -> torch.Tensor:
    """The bit-reversed input after DIT stages 0 .. stages-1, raw words:
    the plain stage loop, which the kernels' passes are held against."""
    n = x.shape[-1]
    lead = tuple(x.shape[:-1])
    v = torch.index_select(x, -1, _bitrev(n, x.device))
    for s, tw in enumerate(_stage_twiddles(log2_strict(n), x.device)[:stages]):
        m = 1 << s
        v = v.reshape(lead + (n // (2 * m), 2, m))
        a = v[..., 0, :]
        b = gl64.mul(v[..., 1, :], tw)
        v = torch.stack([gl64.add(a, b), gl64.sub(a, b)], dim=-2)
    return v.reshape(lead + (n,))


def ntt_plain(x: torch.Tensor) -> torch.Tensor:
    return gl64.canonical(ntt_stages_plain(x, log2_strict(x.shape[-1])))


def intt_plain(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    c = ntt_plain(x)
    idx = _cached(("reverse", n, str(x.device)), lambda: torch.from_numpy(
        np.concatenate([[0], np.arange(n - 1, 0, -1)]).astype(np.int64)).to(x.device))
    c = torch.index_select(c, -1, idx)
    return gl64.canonical(gl64.mul(c, gl64.const(pow(n, P - 2, P), device=x.device)))


def coset_fft_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    return ntt_plain(gl64.mul(x, _powers(shift, x.shape[-1], x.device)))


def coset_ifft_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    inv_powers = _powers(pow(shift, P - 2, P), x.shape[-1], x.device)
    return gl64.canonical(gl64.mul(intt_plain(x), inv_powers))


def coset_lde_plain(x: torch.Tensor, rate_bits: int, shift: int) -> torch.Tensor:
    n = x.shape[-1]
    padded = torch.zeros(tuple(x.shape[:-1]) + (n << rate_bits,), dtype=x.dtype,
                         device=x.device)
    padded[..., :n] = x
    return coset_fft_plain(padded, shift)


# ntt_kernel.plan's arguments for each transform on the card: the front's
# powers, the output length, the epilogue and its scalings
def ntt_kernel_args(x: torch.Tensor) -> dict:
    return {}


def intt_kernel_args(x: torch.Tensor) -> dict:
    return {"epilogue": NK.INVERSE, "n_inv": pow(x.shape[-1], P - 2, P)}


def coset_fft_kernel_args(x: torch.Tensor, shift: int) -> dict:
    return {"powers": _powers(shift, x.shape[-1], x.device)}


def coset_ifft_kernel_args(x: torch.Tensor, shift: int) -> dict:
    n = x.shape[-1]
    return {"epilogue": NK.INVERSE_COSET, "n_inv": pow(n, P - 2, P),
            "inv_powers": _powers(pow(shift, P - 2, P), n, x.device)}


def coset_lde_kernel_args(x: torch.Tensor, rate_bits: int, shift: int) -> dict:
    n = x.shape[-1]
    return {"n_out": n << rate_bits, "powers": _powers(shift, n, x.device)}


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Batched NTT along the last axis: [..., n] coefficients -> [..., n]
    evaluations over H in natural order; any representatives in, canonical
    out."""
    if not _on_card(x):
        return ntt_plain(x)
    return NK.transform(x, **ntt_kernel_args(x))


def intt(x: torch.Tensor) -> torch.Tensor:
    if not _on_card(x):
        return intt_plain(x)
    return NK.transform(x, **intt_kernel_args(x))


def coset_fft(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Evaluate p(shift * x) over H, i.e. p over the coset shift * H."""
    if not _on_card(x):
        return coset_fft_plain(x, shift)
    return NK.transform(x, **coset_fft_kernel_args(x, shift))


def coset_ifft(x: torch.Tensor, shift: int) -> torch.Tensor:
    """The coefficients of p from its values over the coset shift * H: the
    inverse NTT, then coefficient i times shift^-i."""
    if not _on_card(x):
        return coset_ifft_plain(x, shift)
    return NK.transform(x, **coset_ifft_kernel_args(x, shift))


def coset_lde(x: torch.Tensor, rate_bits: int, shift: int) -> torch.Tensor:
    """Zero-pad the coefficients by 2^rate_bits, evaluate over shift * H'."""
    if not _on_card(x):
        return coset_lde_plain(x, rate_bits, shift)
    return NK.transform(x, **coset_lde_kernel_args(x, rate_bits, shift))


# ------------------------------------------------------------- distributed
def _dft_matmul(dft: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """out[..., a, c] = sum_b dft[a, b] * x[..., b, c] (mod p) for a small
    D x D matrix: a sum of field products, D^2 of them."""
    rows = []
    for a in range(dft.shape[0]):
        acc = None
        for b in range(dft.shape[1]):
            term = gl64.mul(x[..., b, :], gl64.const(int(dft[a, b]), device=x.device))
            acc = term if acc is None else gl64.add(acc, term)
        rows.append(acc)
    return torch.stack(rows, dim=-2)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all over the leading axis: chunk i of x goes to rank i, chunk
    j of the result came from rank j. The words cross as they are."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _four_step_tables(n: int, D: int):
    """(dft [D, D], twiddles [D, n / D]) as uint64: the D-point DFT matrix
    of the primitive D-th root w^(n/D), and w^(k1 * j2)."""
    def make():
        w = ntt_np.primitive_root_of_unity(log2_strict(n))
        n2 = n // D
        wd = pow(w, n2, P)
        dft = np.array([[pow(wd, a * b, P) for b in range(D)] for a in range(D)],
                       dtype=np.uint64)
        tw = np.stack([ntt_np.powers(pow(w, k1, P), n2) for k1 in range(D)])
        return dft, tw
    return _cached(("four_step", n, D), make)


def ntt_4step(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The NTT of a length-n vector whose last axis is split over the D
    ranks of `mesh[axis]`: `x` is this rank's contiguous shard [..., n / D]
    (rank d holds positions [d n / D, (d + 1) n / D)), the result is this
    rank's contiguous shard of the natural-order NTT. Needs D^2 | n.

    With n = D * n2 and j = j1 * n2 + j2: (1) all_to_all, so that rank d
    holds columns [d c, (d + 1) c) of every row j1 (c = n2 / D); (2) the
    D-point DFT over j1; (3) times w^(k1 * j2); (4) all_to_all back, so
    that rank k1 holds row k1 whole; (5) the local n2-point NTT, Y[k1][k2]
    = X[k2 * D + k1]; (6) all_to_all to natural order."""
    group = mesh.get_group(axis)
    D = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n2 = x.shape[-1]
    n = n2 * D
    if n2 % D:
        raise ValueError(f"ntt_4step: {D} ranks need D^2 | n, and n = {n}")
    c = n2 // D
    lead = tuple(x.shape[:-1])
    nd = len(lead)
    dft, tw = _four_step_tables(n, D)
    to_front = (nd,) + tuple(range(nd)) + (nd + 1,)  # [..., D, c] -> [D, ..., c]
    to_back = tuple(range(1, nd + 1)) + (0, nd + 1)  # [D, ..., c] -> [..., D, c]
    # (1) chunk d2 of every rank's row to rank d2: [..., D(j1), c]
    ex = _exchange(x.reshape(lead + (D, c)).permute(to_front), group).permute(to_back)
    # (2) column DFT, (3) twiddles of this rank's columns j2 = rank * c + t
    col = _dft_matmul(dft, ex)
    col = gl64.mul(col, gl64.from_u64(tw[:, rank * c:(rank + 1) * c], x.device))
    # (4) row k1 to rank k1: [..., D(source rank), c] -> [..., n2]
    back = _exchange(col.permute(to_front), group).permute(to_back).reshape(lead + (n2,))
    # (5) the local row transform
    y = ntt(back)
    # (6) out[r n2 + t D + d] = Y[d][r c + t]: chunk r of every rank to rank r
    got = _exchange(y.reshape(lead + (D, c)).permute(to_front), group)
    return got.permute(tuple(range(1, nd + 1)) + (nd + 1, 0)).reshape(lead + (n2,))
