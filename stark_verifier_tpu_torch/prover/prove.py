"""plonky2-compatible prover, batched over witnesses, on a device.

Produces proofs that both verifiers accept, with the transcript schedule
the reference constrains. The whole pipeline carries a leading batch of
witnesses of one circuit, as int64 tensors on the circuit's device: wire
NTTs and LDEs (ops/ntt), Merkle forests (core/merkle, one Poseidon kernel
launch a sponge chunk or a level for the whole batch), the permutation
argument, the quotient (the gates over `rings.BaseRing` on [B, lde_n]
tensors), the openings, DEEP, the FRI commit phase, the proof-of-work grind
(candidate tiles hashed by the kernel) and the queries. Proofs come out as
`core.types.Proof` objects of numpy uint64 arrays.

Random draws (blinding rows, salts) are made on the host from numpy
generators the caller may pass, with the JAX package's calls, shapes and
order, then moved to the device: under the same seeds the proofs are bit
for bit the JAX package's.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..core import gates as G
from ..core.challenger import Challenger
from ..core.merkle import MerkleTree
from ..core.rings import BaseRing
from ..core.types import FriProof, FriQueryRounds, OpeningSet, Proof
from ..ops import ext2, gl64, ntt, ntt_np
from ..ops import poseidon_gl as pg
from ..ops.hashers import get_permute
from . import lde as _lde
from .builder import CircuitData, WitnessConflict, require_device

SHIFT = 7  # multiplicative group generator; the LDE coset is 7*H
P = gl64.P


class _Stages:
    """Marks the stages of one prove_batch call: prints them under
    SVT_PROVER_VERBOSE, and, when given a dict, adds each one's wall time
    in ms to it (synchronizing a CUDA device at every mark)."""

    def __init__(self, out, device):
        self.out, self.device = out, device
        self.name, self.t0 = None, None

    def __call__(self, name=None):
        if self.out is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            if self.name is not None:
                self.out[self.name] = (self.out.get(self.name, 0.0)
                                       + (now - self.t0) * 1e3)
            self.name, self.t0 = name, now
        if name and os.environ.get("SVT_PROVER_VERBOSE"):
            print(f"[prove {time.strftime('%H:%M:%S')}] {name}", flush=True)


def _observe_cap_batch(ch: Challenger, cap: torch.Tensor):
    """cap: [c, 4] (shared) or [B, c, 4] (batched)."""
    if cap.dim() == 2:
        for r in range(cap.shape[0]):
            for i in range(4):
                ch.observe_element(cap[r, i].expand(ch.shape))
    else:
        for r in range(cap.shape[1]):
            for i in range(4):
                ch.observe_element(cap[:, r, i])


def _ext_powers(F, point, n: int):
    """z^0..z^{n-1} for ext z = ([B], [B]) -> ([B, n], [B, n]), by
    log-doubling: [1] -> [1, z] -> [1, z, z^2, z^3] -> ..."""
    B = point[0].shape[0]
    pw = (F.ones((B, 1)), F.zeros((B, 1)))
    cur = point  # z^(current width)
    while pw[0].shape[1] < n:
        blk = ext2.mul(F, pw, (cur[0][:, None], cur[1][:, None]))
        pw = (torch.cat([pw[0], blk[0]], dim=1), torch.cat([pw[1], blk[1]], dim=1))
        cur = ext2.square(F, cur)
    return (pw[0][:, :n], pw[1][:, :n])


def _base_powers(F, a, n: int):
    """a^0..a^{n-1} for base a [B] -> [n, B], by log-doubling."""
    pw = F.ones((1,) + tuple(a.shape))
    cur = a
    while pw.shape[0] < n:
        pw = torch.cat([pw, F.mul(pw, cur)], dim=0)
        cur = F.mul(cur, cur)
    return pw[:n]


def _gl_sum_last(F, x):
    """Modular sum along the last axis by halving folds."""
    while x.shape[-1] > 1:
        last = None
        if x.shape[-1] % 2:
            last, x = x[..., -1], x[..., :-1]
        x = F.add(x[..., 0::2], x[..., 1::2])
        if last is not None:
            x = torch.cat([F.add(x[..., :1], last[..., None]), x[..., 1:]], dim=-1)
    return x[..., 0]


def _poly_eval(F, coeffs, point):
    """Base-field polynomials at an ext point: coeffs [P, n] (shared) or
    [P, B, n], point ([B], [B]) -> ([P, B], [P, B]). The two coordinates
    are independent dot products with the power table."""
    zp = _ext_powers(F, point, coeffs.shape[-1])  # [B, n]
    if coeffs.dim() == 2:
        coeffs = coeffs[:, None, :]
    return (_gl_sum_last(F, F.mul(coeffs, zp[0][None])),
            _gl_sum_last(F, F.mul(coeffs, zp[1][None])))


def _alpha_combine(F, coeffs, alpha):
    """sum_i alpha^i * p_i for base-coefficient polys [P, B, n] -> [B, n]
    ext: the powers of alpha as a table, one product and one sum over P."""
    a = _ext_powers(F, alpha, coeffs.shape[0])  # [B, P]
    return tuple(F.sum_axis0(F.mul(coeffs, c.T[:, :, None])) for c in a)


def _deep_quotient(F, comp, point):
    """(comp(X) - comp(z)) / (X - z): [B, n] ext coeffs -> [B, n] ext
    coeffs (top coefficient zero).

    The synthetic-division recurrence q_{k-1} = c_k + z*q_k closes to
    q_{k-1} = z^{-k} * S_k with S_k = sum_{m>=k} c_m z^m: a power table, a
    suffix sum (Hillis-Steele log-doubling) and a power table of z^{-1}. At
    z = 0 the division is the Horner loop."""
    B, n = comp[0].shape
    if bool((F.is_zero(point[0]) & F.is_zero(point[1])).any()):
        return _deep_quotient_horner(F, comp, point)
    zp = _ext_powers(F, point, n)
    s0, s1 = ext2.mul(F, comp, zp)  # t_m = c_m z^m
    d = 1
    while d < n:
        s0 = torch.cat([F.add(s0[:, :-d], s0[:, d:]), s0[:, -d:]], dim=1)
        s1 = torch.cat([F.add(s1[:, :-d], s1[:, d:]), s1[:, -d:]], dim=1)
        d <<= 1
    zip_ = _ext_powers(F, ext2.inv(F, point), n)  # z^0..z^{-(n-1)}
    q = ext2.mul(F, (s0[:, 1:], s1[:, 1:]), (zip_[0][:, 1:], zip_[1][:, 1:]))
    zero = F.zeros((B, 1))
    return (torch.cat([q[0], zero], dim=1), torch.cat([q[1], zero], dim=1))


def _deep_quotient_horner(F, comp, point):
    """Sequential synthetic division (the z = 0 path)."""
    B, n = comp[0].shape
    q0, q1 = F.zeros((B, n)), F.zeros((B, n))
    acc = None
    for k in range(n - 1, 0, -1):
        c = (comp[0][:, k], comp[1][:, k])
        acc = c if acc is None else ext2.add(F, c, ext2.mul(F, acc, point))
        q0[:, k - 1] = acc[0]
        q1[:, k - 1] = acc[1]
    return (q0, q1)


def _ext_mul_scalar_poly(F, poly, s):
    """poly [B, n] ext * s [B] ext."""
    return ext2.mul(F, poly, (s[0][:, None], s[1][:, None]))


def leading_bits_zero(F, x, bits: int):
    """True where the top `bits` bits of the canonical 64-bit value are 0:
    a logical shift of the int64 bit pattern, masked as gl64.bit is (the
    arithmetic shift would smear the sign bit down)."""
    if bits == 0:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return ((F.canonical(x) >> (64 - bits)) & ((1 << bits) - 1)) == 0


def _grind_pow(ch: Challenger, pow_bits: int, B: int, chunk: int = 1 << 13):
    """Per-proof witnesses w such that observing w then squeezing yields a
    challenge with `pow_bits` leading zero bits: the lowest such w of every
    lane. Candidates go in tiles of [B, chunk] through a copy of the
    transcript, one permutation (one kernel launch) a tile, for the lanes
    still without a hit; a lane keeps its first hit."""
    F = ch.F
    out = F.zeros((B,))
    todo = torch.arange(B, device=F.device)  # lanes without a hit yet
    base = 0
    while todo.numel():
        cands = torch.arange(base, base + chunk, dtype=torch.int64, device=F.device)
        sim = _clone_challenger_broadcast(ch, todo, chunk)
        sim.observe_element(cands[None, :].expand(todo.numel(), chunk))
        okm = leading_bits_zero(F, sim.get_challenge(), pow_bits)  # [lanes, chunk]
        hit = okm.any(dim=1)
        first = okm.to(torch.int8).argmax(dim=1)  # the first maximum
        out[todo[hit]] = cands[first[hit]]
        todo = todo[~hit]
        base += chunk
    return out


def _clone_challenger_broadcast(ch: Challenger, lanes, chunk: int):
    """A copy of the transcript `ch` [B] for the lanes `lanes`, each
    broadcast over `chunk` candidates."""
    shape = (lanes.numel(), chunk)
    c = Challenger(ch.F, shape, permute=ch.permute_fn)

    def widen(x):
        return x.expand(ch.shape)[lanes][:, None].expand(shape)

    c.state = [widen(s) for s in ch.state]
    c.input_buffer = [widen(x) for x in ch.input_buffer]
    c.output_buffer = [widen(x) for x in ch.output_buffer]
    return c


def _pack_ext(F, ext_arr, a, b):
    """([P, B], [P, B]) ext rows a:b -> uint64 [B, b - a, 2]."""
    return np.stack([F.to_u64(ext_arr[0][a:b]), F.to_u64(ext_arr[1][a:b])],
                    axis=-1).transpose(1, 0, 2)


def prove_batch(data: CircuitData, inputs: Dict, batch: int, hasher: str = None,
                check_witness: bool = True, device="cuda",
                witness_rng: np.random.Generator = None,
                salt_rng: np.random.Generator = None, permute=None,
                inner_permute=None, stage_ms: dict = None,
                max_lanes: int = None) -> List[Proof]:
    """Prove `batch` witnesses of the circuit `data` on `device` (the
    device the circuit was built on; "cuda" by default, which raises
    without a card). `inputs` maps targets to [batch] values.

    `witness_rng` draws the blinding rows and `salt_rng` the salts (None = a
    fresh `np.random.default_rng()` each, drawn in that order). `hasher`
    names the transcript and Merkle hash config (default: the circuit's);
    `permute` overrides that permutation and `inner_permute` the
    public-input hash's (default: Goldilocks Poseidon), e.g.
    `poseidon_gl.permute_plain` to run the plain version on the card.
    `stage_ms`, if given, receives each stage's wall time in ms, summed
    over the chunks.

    `max_lanes` proves a wider batch as sequential sub-batches of at most
    that many lanes, the inputs sliced on their last axis, as the JAX
    package does (None reads SVT_PROVE_CHUNK; 0 proves in one batch): each
    chunk's working set is its own, so the peak stays that of one chunk.
    Given generators are drawn from by each chunk in turn; without them
    each chunk draws a fresh witness generator, then a fresh salt one."""
    if max_lanes is None:
        max_lanes = int(os.environ.get("SVT_PROVE_CHUNK", "0"))
    if max_lanes and batch > max_lanes:
        out: List[Proof] = []
        for s in range(0, batch, max_lanes):
            e = min(batch, s + max_lanes)
            sub = {t: v[..., s:e] if np.ndim(v) else v for t, v in inputs.items()}
            out.extend(prove_batch(
                data, sub, e - s, hasher=hasher, check_witness=check_witness,
                device=device, witness_rng=witness_rng, salt_rng=salt_rng,
                permute=permute, inner_permute=inner_permute, stage_ms=stage_ms,
                max_lanes=0))
        return out
    device = require_device(device)
    if device != data.device:
        raise ValueError(f"the circuit was built on {data.device}; prove on it, "
                         f"not on {device}")
    F = gl64.Field(device)
    stages = _Stages(stage_ms, device)
    common = data.common
    cfg = common.config
    hperm = permute or get_permute(hasher or getattr(cfg, "hasher", "poseidon"), F)
    inner = inner_permute or pg.permute
    n = common.degree
    rate_bits = cfg.fri_config.rate_bits
    lde_n = n << rate_bits
    cap_h = cfg.fri_config.cap_height
    nc = cfg.num_challenges
    nr = cfg.num_routed_wires
    qdf = common.quotient_degree_factor
    B = batch

    # ---- 1. witness
    stages("witness")
    W, pis = data.generate_witness(inputs, batch, check=check_witness,
                                   rng=witness_rng, inner_permute=inner)
    W = W.transpose(1, 2).contiguous()  # [nw, B, n]

    # ---- 2. wires commitment
    stages("wires commit")
    hiding = common.fri_params.hiding
    salt_rng = np.random.default_rng() if salt_rng is None else salt_rng
    bitrev = ntt._bitrev(lde_n, device)

    def commit(values_lde):
        """Bit-reversed leaves [B, lde_n, polys] of an LDE [polys, B,
        lde_n], salted on a hiding proof (SALT_SIZE random columns, which
        the verifier strips), and their tree."""
        leaves = torch.index_select(values_lde.movedim(0, -1), -2, bitrev)
        if hiding:
            salt = salt_rng.integers(0, P, size=tuple(leaves.shape[:-1]) + (4,),
                                     dtype=np.uint64)
            leaves = torch.cat([leaves, F.from_u64(salt)], dim=-1)
        return MerkleTree(leaves, cap_h, permute=hperm)

    wire_coeffs = ntt.intt(W)
    wire_lde = _lde.coset_lde(wire_coeffs, rate_bits, SHIFT)  # [nw, B, lde_n]
    wires_tree = commit(wire_lde)

    # ---- 3. transcript: digest, PI hash, wires cap -> betas, gammas
    pi_hash = pg.hash_no_pad(F, list(pis), shape=(B,), permute=inner)
    ch = Challenger(F, shape=(B,), permute=hperm)
    for i in range(4):
        ch.observe_element(data.circuit_digest[i].expand(B))
    for h in pi_hash:
        ch.observe_element(h)
    _observe_cap_batch(ch, wires_tree.cap)
    betas = [ch.get_challenge() for _ in range(nc)]
    gammas = [ch.get_challenge() for _ in range(nc)]

    # ---- 4. permutation argument: Z polys + partial products
    stages("permutation argument")
    num_chunks = (nr + qdf - 1) // qdf
    subgroup = F.from_u64(data.subgroup)
    s_id = F.mul(F.from_u64(common.k_is)[:, None], subgroup[None, :])  # [nr, n]
    sigmas = F.from_u64(data.sigma_vals)
    zs, all_pps = [], []
    for i in range(nc):
        beta, gamma = betas[i][None, :, None], gammas[i][None, :, None]
        nums = F.add(F.add(W[:nr], F.mul(beta, s_id[:, None, :])), gamma)
        dens = F.add(F.add(W[:nr], F.mul(beta, sigmas[:, None, :])), gamma)
        num_prod = _chunk_products(F, nums, qdf)  # [num_chunks, B, n]
        ratio = F.mul(num_prod, F.inv(_chunk_products(F, dens, qdf)))
        quot = ratio[0]
        for c in range(1, num_chunks):
            quot = F.mul(quot, ratio[c])
        # Z(w^0) = 1, Z(w^{j+1}) = Z(w^j) * quot(w^j): an exclusive prefix
        # product over the rows, by Hillis-Steele log-doubling
        pp = quot
        d = 1
        while d < n:
            pp = torch.cat([pp[:, :d], F.mul(pp[:, d:], pp[:, :-d])], dim=1)
            d <<= 1
        Z = torch.cat([F.ones((B, 1)), pp[:, :-1]], dim=1)
        zs.append(Z)
        # partial products: the accumulator after each chunk but the last
        acc, pps_i = Z, []
        for c in range(num_chunks - 1):
            acc = F.mul(acc, ratio[c])
            pps_i.append(acc)
        all_pps.extend(pps_i)
    zs_pp_values = torch.stack(zs + all_pps)  # [nc * (1 + npp), B, n]
    zs_pp_coeffs = ntt.intt(zs_pp_values)
    zs_pp_lde = _lde.coset_lde(zs_pp_coeffs, rate_bits, SHIFT)
    zs_pp_tree = commit(zs_pp_lde)
    _observe_cap_batch(ch, zs_pp_tree.cap)
    alphas = [ch.get_challenge() for _ in range(nc)]

    # ---- 5. quotient polynomials
    stages("quotient")
    quotient_polys = _compute_quotient(data, F, wire_lde, zs_pp_lde, pi_hash,
                                       betas, gammas, alphas, B)  # [nc*qdf, B, n]
    q_lde = _lde.coset_lde(quotient_polys, rate_bits, SHIFT)
    q_tree = commit(q_lde)
    _observe_cap_batch(ch, q_tree.cap)
    zeta = (ch.get_challenge(), ch.get_challenge())

    # ---- 6. openings at zeta and g*zeta
    stages("openings")
    g_n = int(data.subgroup[1]) if n > 1 else 1
    zeta_next = ext2.scalar_mul(F, zeta, F.const(g_n))
    cs_coeffs = data.constants_sigmas_coeffs  # [ncst + nr, n]
    n_consts = common.num_constants
    open_cs = _poly_eval(F, cs_coeffs, zeta)  # [ncst + nr, B] ext
    open_wires = _poly_eval(F, wire_coeffs, zeta)
    open_zs_pp = _poly_eval(F, zs_pp_coeffs, zeta)
    open_q = _poly_eval(F, quotient_polys, zeta)
    open_zs_next = _poly_eval(F, zs_pp_coeffs[:nc], zeta_next)
    npp = common.num_partial_products
    openings = OpeningSet(
        constants=_pack_ext(F, open_cs, 0, n_consts),
        plonk_sigmas=_pack_ext(F, open_cs, n_consts, n_consts + nr),
        wires=_pack_ext(F, open_wires, 0, cfg.num_wires),
        plonk_zs=_pack_ext(F, open_zs_pp, 0, nc),
        plonk_zs_next=_pack_ext(F, open_zs_next, 0, nc),
        partial_products=_pack_ext(F, open_zs_pp, nc, nc * (1 + npp)),
        quotient_polys=_pack_ext(F, open_q, 0, nc * qdf),
    )
    # transcript order: constants, sigmas, wires, zs, partial products,
    # quotient (the storage order here), then zs_next
    for ext_arr in (open_cs, open_wires, open_zs_pp, open_q, open_zs_next):
        for k in range(ext_arr[0].shape[0]):
            ch.observe_element(ext_arr[0][k])
            ch.observe_element(ext_arr[1][k])
    fri_alpha = (ch.get_challenge(), ch.get_challenge())

    # ---- 7. DEEP composition -> the polynomial FRI commits to (ext coeffs)
    b0_coeffs = torch.cat([cs_coeffs[:, None, :].expand(-1, B, -1), wire_coeffs,
                           zs_pp_coeffs, quotient_polys], dim=0)  # [P0, B, n]
    q0 = _deep_quotient(F, _alpha_combine(F, b0_coeffs, fri_alpha), zeta)
    q1 = _deep_quotient(F, _alpha_combine(F, zs_pp_coeffs[:nc], fri_alpha), zeta_next)
    q0_shifted = _ext_mul_scalar_poly(F, q0, ext2.pow_const(F, fri_alpha, nc, (B,)))
    final_coeffs = ext2.add(F, q0_shifted, q1)

    # ---- 8. FRI commit phase
    stages("fri commit")
    coeffs = tuple(torch.cat([c, F.zeros((B, lde_n - n))], dim=1) for c in final_coeffs)
    values = tuple(ntt.coset_fft(c, SHIFT) for c in coeffs)
    shift = SHIFT
    commit_trees = []
    for arity_bits in common.fri_params.reduction_arity_bits:
        arity = 1 << arity_bits
        m = values[0].shape[1]
        rev = ntt._bitrev(m, device)
        # leaf = the flattened coset: [e0c0, e0c1, e1c0, e1c1, ...]
        leaves = torch.stack([torch.index_select(v, 1, rev) for v in values],
                             dim=-1).reshape(B, m // arity, 2 * arity)
        tree = MerkleTree(leaves, min(cap_h, (m // arity).bit_length() - 1),
                          permute=hperm)
        commit_trees.append(tree)
        _observe_cap_batch(ch, tree.cap)
        beta = (ch.get_challenge(), ch.get_challenge())
        # fold the coefficients: c'_i = sum_j beta^j c_{arity*i + j}
        mc = coeffs[0].shape[1]
        c0 = coeffs[0].reshape(B, mc // arity, arity)
        c1 = coeffs[1].reshape(B, mc // arity, arity)
        acc = (c0[:, :, arity - 1], c1[:, :, arity - 1])
        for j in range(arity - 2, -1, -1):
            acc = ext2.add(F, ext2.mul(F, acc, (beta[0][:, None], beta[1][:, None])),
                           (c0[:, :, j], c1[:, :, j]))
        coeffs = acc
        shift = pow(shift, arity, P)
        values = tuple(ntt.coset_fft(c, shift) for c in coeffs)
    # the final polynomial: its true coefficients (the zero tail removed)
    flen = coeffs[0].shape[1] >> rate_bits
    final_poly = torch.stack([F.canonical(coeffs[0][:, :flen]),
                              F.canonical(coeffs[1][:, :flen])], dim=-1)
    for k in range(flen):
        ch.observe_element(final_poly[:, k, 0])
        ch.observe_element(final_poly[:, k, 1])

    # ---- 9. proof-of-work grind
    stages("pow grind")
    pow_bits = cfg.fri_config.proof_of_work_bits
    pow_witness = _grind_pow(ch, pow_bits, B)
    ch.observe_element(pow_witness)
    if not bool(leading_bits_zero(F, ch.get_challenge(), pow_bits).all()):
        raise RuntimeError("proof-of-work grind returned a witness that fails the check")
    nq = cfg.fri_config.num_query_rounds
    q_indices = torch.stack([F.canonical(ch.get_challenge()) & (lde_n - 1)
                             for _ in range(nq)], dim=1)  # [B, Q]

    # ---- 10. query round proofs
    stages("queries")
    initial_trees = [data.constants_sigmas_tree, wires_tree, zs_pp_tree, q_tree]
    init_evals = [F.to_u64(t.leaves_at(q_indices)) for t in initial_trees]
    init_sibs = [F.to_u64(t.prove_batch(q_indices)) for t in initial_trees]
    step_evals, step_sibs = [], []
    idx = q_indices
    for tree, arity_bits in zip(commit_trees, common.fri_params.reduction_arity_bits):
        idx = idx >> arity_bits
        leaf = F.to_u64(tree.leaves_at(idx))  # [B, Q, 2 * arity]
        step_evals.append(leaf.reshape(leaf.shape[:-1] + (1 << arity_bits, 2)))
        step_sibs.append(F.to_u64(tree.prove_batch(idx)))

    # ---- assemble the per-proof objects
    caps = [F.to_u64(t.cap) for t in (wires_tree, zs_pp_tree, q_tree)]
    commit_caps = [F.to_u64(t.cap) for t in commit_trees]
    final_np = F.to_u64(final_poly)
    pow_np = F.to_u64(pow_witness)
    pis_np = F.to_u64(pis)
    proofs = []
    for b in range(B):
        qr = FriQueryRounds(
            initial_evals=[e[b] for e in init_evals],
            initial_siblings=[s[b] for s in init_sibs],
            step_evals=[e[b] for e in step_evals],
            step_siblings=[s[b] for s in step_sibs],
        )
        proofs.append(Proof(
            wires_cap=caps[0][b],
            plonk_zs_partial_products_cap=caps[1][b],
            quotient_polys_cap=caps[2][b],
            openings=OpeningSet(**{f: getattr(openings, f)[b] for f in (
                "constants", "plonk_sigmas", "wires", "plonk_zs",
                "plonk_zs_next", "partial_products", "quotient_polys")}),
            opening_proof=FriProof(
                commit_phase_caps=np.stack([c[b] for c in commit_caps])
                if commit_caps else np.zeros((0, 1 << cap_h, 4), np.uint64),
                query_rounds=qr,
                final_poly=final_np[b],
                pow_witness=pow_np[b],
            ),
            public_inputs=pis_np[:, b],
        ))
    stages()
    return proofs


def coset_points(F, lde_bits: int) -> torch.Tensor:
    """The LDE coset's points 7 * w^j, j < 2^lde_bits, on F's device: the
    NTT's cached power table times the shift, no host loop."""
    w = ntt_np.primitive_root_of_unity(lde_bits)
    return F.mul(ntt._powers(w, 1 << lde_bits, F.device), F.const(SHIFT))


def _chunk_products(F, terms, qdf: int):
    """Products of consecutive groups of qdf rows: [k, ...] -> [ceil(k /
    qdf), ...] (the last group may be short)."""
    k = terms.shape[0]
    chunks = (k + qdf - 1) // qdf
    pad = chunks * qdf - k
    if pad:
        terms = torch.cat([terms, F.ones((pad,) + tuple(terms.shape[1:]))], dim=0)
    terms = terms.reshape((chunks, qdf) + tuple(terms.shape[1:]))
    prod = terms[:, 0]
    for j in range(1, qdf):
        prod = F.mul(prod, terms[:, j])
    return prod


def _compute_quotient(data, F, wire_lde, zs_pp_lde, pi_hash, betas, gammas,
                      alphas, B):
    """Evaluate the vanishing polynomial on the LDE coset and divide by Z_H.
    Returns the quotient chunk polys [nc * qdf, B, n] (coefficients); a
    quotient above degree qdf * n (unsatisfied constraints) raises
    WitnessConflict."""
    common = data.common
    cfg = common.config
    n = common.degree
    lde_n = n << cfg.fri_config.rate_bits
    nc = cfg.num_challenges
    nr = cfg.num_routed_wires
    qdf = common.quotient_degree_factor
    npp = common.num_partial_products

    R = BaseRing(F, (B, lde_n))
    x = coset_points(F, common.fri_params.lde_bits)  # [lde_n]

    csl = data.constants_sigmas_lde  # [ncst + nr, lde_n]
    n_consts = common.num_constants
    local_constants = [csl[i] for i in range(n_consts)]
    sigmas = csl[n_consts:n_consts + nr]
    local_wires = list(wire_lde)
    pi_h = [h[:, None] for h in pi_hash]

    # gate constraints
    combined = [R.zero() for _ in range(common.num_gate_constraints)]
    num_selectors = common.selectors_info.num_selectors
    for i, gate in enumerate(common.gates):
        si = common.selectors_info.selector_indices[i]
        group = range(*common.selectors_info.groups[si])
        G.eval_filtered(R, gate, si, group, num_selectors, i,
                        local_constants, local_wires, pi_h, combined)

    # L_0(x) = (x^n - 1) / (n (x - 1)), on the coset points alone
    z_h = F.sub(F.pow_const(x, n), F.ones((lde_n,)))
    l0 = F.mul(z_h, F.inv(F.mul(F.const(n), F.sub(x, F.ones((lde_n,))))))
    s_ids = F.mul(F.from_u64(common.k_is)[:, None], x[None, :])  # [nr, lde_n]

    rot = 1 << cfg.fri_config.rate_bits
    z1_terms, pp_terms = [], []
    for i in range(nc):
        z_x = zs_pp_lde[i]
        z_gx = torch.roll(z_x, -rot, dims=-1)
        z1_terms.append(F.sub(F.mul(l0, z_x), l0))
        beta, gamma = betas[i][None, :, None], gammas[i][None, :, None]
        wpg = F.add(wire_lde[:nr], gamma)  # [nr, B, lde_n]
        num_prod = _chunk_products(F, F.add(F.mul(beta, s_ids[:, None, :]), wpg), qdf)
        den_prod = _chunk_products(F, F.add(F.mul(beta, sigmas[:, None, :]), wpg), qdf)
        accs = torch.stack([z_x] + list(zs_pp_lde[nc + i * npp:nc + (i + 1) * npp])
                           + [z_gx])  # [num_chunks + 1, B, lde_n]
        pp_terms.extend(F.sub(F.mul(accs[:-1], num_prod), F.mul(accs[1:], den_prod)))

    terms = torch.stack(torch.broadcast_tensors(*(z1_terms + pp_terms + combined)))
    z_h_inv = F.inv(z_h)
    out = []
    for i in range(nc):
        # sum_t alpha^t * term_t (the Horner order of the reference)
        a = _base_powers(F, alphas[i], terms.shape[0])[:, :, None]  # [T, B, 1]
        vanishing = F.sum_axis0(F.mul(terms, a))
        q_coeffs = ntt.coset_ifft(F.mul(vanishing, z_h_inv), SHIFT)  # [B, lde_n]
        if bool((q_coeffs[:, qdf * n:] != 0).any()):
            raise WitnessConflict("quotient degree overflow: constraints unsatisfied")
        out.append(q_coeffs[:, :qdf * n].reshape(B, qdf, n).transpose(0, 1))
    return torch.cat(out, dim=0)
