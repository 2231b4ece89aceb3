"""Prover LDE backends: the coset low-degree extension is the prover's FFT
plane (the wires, zs-and-partial-products and quotient oracles each commit
to one; see prove.py). Two backends, both on the device of the input:

  device — `ops/ntt.coset_lde`, the batched radix-2 NTT (the default)
  mesh   — the transform axis split over the ranks of the process group
           with `ops/ntt.ntt_4step` (three all_to_all exchanges), the
           shards gathered back on every rank

Where the mesh cannot split the transform (one rank, or D^2 not dividing
the LDE length) `mesh` takes the `device` transform on the same device.
Bit-exact across backends. Selected per call or by SVT_PROVER_LDE.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..ops import gl64, ntt


def _scaled_pad(coeffs: torch.Tensor, rate_bits: int, shift: int) -> torch.Tensor:
    """Zero-pad to the LDE length and fold the coset shift into the
    coefficients: p(shift*x) has coefficients c_i * shift^i."""
    n = coeffs.shape[-1]
    scaled = gl64.mul(coeffs, ntt._powers(shift, n, coeffs.device))
    out = torch.zeros(tuple(coeffs.shape[:-1]) + (n << rate_bits,),
                      dtype=coeffs.dtype, device=coeffs.device)
    out[..., :n] = scaled
    return out


def coset_lde(coeffs: torch.Tensor, rate_bits: int, shift: int,
              backend: str | None = None) -> torch.Tensor:
    """coeffs int64 [..., n] -> evaluations int64 [..., n << rate_bits] on
    the coset shift * H', canonical, on the input's device."""
    backend = backend or os.environ.get("SVT_PROVER_LDE", "device")
    if backend == "device":
        return ntt.coset_lde(coeffs, rate_bits, shift)
    if backend == "mesh":
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(axis="ntt")
        group = mesh.get_group("ntt")
        D = dist.get_world_size(group)
        n_lde = coeffs.shape[-1] << rate_bits
        if D < 2 or n_lde % (D * D):
            return ntt.coset_lde(coeffs, rate_bits, shift)
        c = n_lde // D
        rank = dist.get_rank(group)
        padded = _scaled_pad(coeffs, rate_bits, shift)
        mine = ntt.ntt_4step(padded[..., rank * c:(rank + 1) * c].contiguous(),
                             mesh, axis="ntt")
        parts = [torch.empty_like(mine) for _ in range(D)]
        dist.all_gather(parts, mine, group=group)
        return torch.cat(parts, dim=-1)
    raise ValueError(f"unknown LDE backend {backend!r}")
