"""Batch-in-lanes plonky2 verifier: the proof batch rides as the LEADING axis
of every element tensor. Query-vector values are [B, Q], scalars are [B], so
every tensor op and every Poseidon kernel launch sees the whole batch: a
transcript step is one permutation of [12, B], a Merkle level one of
[12, B*Q] (or [12, 4*B*Q] for the merged walk of the four initial oracles).
"""
from __future__ import annotations

import torch

from ..ops import ext2
from ..ops import poseidon_gl as pg
from . import verifier as V1
from .challenger import TapeChallenger, resolve_challenges
from .merkle import merkle_walk
from .rings import ExtRing
from .types import CommonData


def _bq(F, e):
    """Lift a [B] scalar-lane element to broadcast against [B, Q]."""
    return e[..., None]


def _bq_ext(F, e):
    return (_bq(F, e[0]), _bq(F, e[1]))


def _all_q(mask):
    """Reduce bool [B, Q] -> [B] (keep the batch axis)."""
    return mask.all(dim=-1) if mask.dim() > 1 else mask


def verify_batched(F, common: CommonData, vk_cap, circuit_digest, pa: dict,
                   permute=None):
    """pa tensors carry a leading batch axis B; returns accept bool [B].

    `permute` overrides the transcript/Merkle/public-input permutation (the
    default follows common.config.hasher and, for the public-input hash,
    is always Goldilocks Poseidon); it exists so the kernel's path can be
    held against the plain version's on the same device."""
    R = ExtRing(F)
    B = pa["public_inputs"].shape[0]
    perm = permute or V1._perm_for(F, common)

    # the public-input hash is plonky2's InnerHasher: Goldilocks Poseidon
    # under every config
    pi_hash = pg.hash_no_pad(
        F, V1._scalar_list(F, pa["public_inputs"]), shape=(B,),
        permute=permute or pg.permute)
    ch = _get_challenges_batched(F, common, pa, pi_hash, circuit_digest, B, perm)

    vanishing, zeta_pow_deg = V1.eval_vanishing_poly(F, common, ch, pa, pi_hash)

    ok = None
    one = R.one()
    z_h_zeta = R.sub(zeta_pow_deg, one)
    quotient_list = V1._ext_list(F, pa["open_quotient_polys"])
    qdf = common.quotient_degree_factor
    for i in range(common.config.num_challenges):
        chunk = quotient_list[i * qdf : (i + 1) * qdf]
        recombined = R.reduce_with_powers(zeta_pow_deg, chunk)
        eq = ext2.equal(F, vanishing[i], R.mul(z_h_zeta, recombined))
        ok = eq if ok is None else (ok & eq)

    alpha = ch.fri_alpha
    batches = V1._opening_batches(F, pa)
    reduced_openings = [ext2.reduce_with_powers(F, alpha, b) for b in batches]
    g_zeta = F.const(V1._g_pow(V1.ORDER >> common.degree_bits))
    zeta_next = ext2.scalar_mul(F, ch.plonk_zeta, g_zeta)
    return _verify_fri_batched(
        F, common, ch, pa, vk_cap, reduced_openings, ch.plonk_zeta,
        zeta_next, ok, B, perm)


def _get_challenges_batched(F, common, pa, pi_hash, circuit_digest, B, perm=None):
    """Replay of plonky2's challenger schedule; replicated verifying-key
    inputs are broadcast to [B] lanes. The duplex schedule is recorded and
    then run as a plain loop of [12, B] permutations (see TapeChallenger)."""
    ch = V1.ProofChallenges()
    nc = common.config.num_challenges
    c = TapeChallenger(F, shape=(B,), permute=perm or V1._perm_for(F, common))
    for e in V1._scalar_list(F, circuit_digest):
        c.observe_element(e.expand(B))
    for e in pi_hash:
        c.observe_element(e)
    c.observe_cap(_digest_rows_b(F, pa["wires_cap"]))
    ch.plonk_betas = c.get_n_challenges(nc)
    ch.plonk_gammas = c.get_n_challenges(nc)
    c.observe_cap(_digest_rows_b(F, pa["zs_pp_cap"]))
    ch.plonk_alphas = c.get_n_challenges(nc)
    c.observe_cap(_digest_rows_b(F, pa["quotient_cap"]))
    ch.plonk_zeta = c.get_extension_challenge()
    flat = [
        x for batch in V1._opening_batches(F, pa) for e in batch
        for x in (e[0], e[1])
    ]
    c.observe_elements(flat)
    ch.fri_alpha = c.get_extension_challenge()
    ch.fri_betas = []
    L = pa["commit_phase_caps"].shape[1]
    for i in range(L):
        c.observe_cap(_digest_rows_b(F, pa["commit_phase_caps"][:, i]))
        ch.fri_betas.append(c.get_extension_challenge())
    c.observe_elements(
        [x for e in V1._ext_list(F, pa["final_poly"]) for x in (e[0], e[1])]
    )
    c.observe_element(pa["pow_witness"])
    ch.fri_pow_response = c.get_challenge()
    ch.fri_query_indices = c.get_n_challenges(
        common.config.fri_config.num_query_rounds)
    vals = c.finalize()
    for f in ("plonk_betas", "plonk_gammas", "plonk_alphas", "plonk_zeta",
              "fri_alpha", "fri_betas", "fri_pow_response",
              "fri_query_indices"):
        setattr(ch, f, resolve_challenges(getattr(ch, f), vals))
    return ch


def _digest_rows_b(F, cap):
    """cap [B, c, 4] -> list of c digests of 4 [B]-elements."""
    return [[cap[:, r, i] for i in range(4)] for r in range(cap.shape[1])]


def _verify_fri_batched(F, common, ch, pa, vk_cap, reduced_openings, zeta,
                        zeta_next, ok, B, perm):
    """FRI verification; query lanes trail the batch axis: [B, Q]."""
    fp = common.fri_params
    lde_bits = fp.lde_bits
    cap_height = fp.config.cap_height
    pow_bits = fp.config.proof_of_work_bits

    # proof of work: the top `pow_bits` bits of the canonical response are 0
    pw = ch.fri_pow_response
    for i in range(64 - pow_bits, 64):
        ok = ok & (F.bit(pw, i) == 0)

    omega = V1.primitive_root(lde_bits)
    xi = F.stack(ch.fri_query_indices, axis=-1)  # [B, Q]
    bits = [F.bit(xi, i) for i in range(lde_bits)]
    cap_index = torch.zeros_like(bits[0])  # int64, as torch.gather wants
    for k, b in enumerate(bits[lde_bits - cap_height:]):
        cap_index = cap_index + (b << k)

    # ---- initial tree proofs: leaf-hash each oracle, then ONE merged path
    # walk over 4*Q lanes (the 4 oracle trees share depth and index bits)
    depth = lde_bits - cap_height
    # the verifying key's cap has no batch axis: lift it
    caps = [vk_cap.expand((B,) + tuple(vk_cap.shape)),
            pa["wires_cap"], pa["zs_pp_cap"], pa["quotient_cap"]]
    evs = [V1._scalar_list(F, pa[f"init_evals_{o}"]) for o in range(4)]  # [B, Q] each
    states = [
        pg.hash_or_noop(F, evs[o], shape=tuple(evs[o][0].shape), permute=perm)
        for o in range(4)
    ]
    big_state = [
        F.concat([states[o][i] for o in range(4)], axis=-1) for i in range(4)
    ]
    big_bits = [F.concat([b] * 4, axis=-1) for b in bits[:depth]]
    big_sibs = [
        [
            F.concat(
                [pa[f"init_sibs_{o}"][..., d, i] for o in range(4)], axis=-1)
            for i in range(4)
        ]
        for d in range(depth)
    ]
    big_state = merkle_walk(F, big_state, big_bits, big_sibs, permute=perm)
    Q = xi.shape[-1]
    for o in range(4):
        expected = _take_cap_b(F, caps[o], cap_index)  # [B, Q, 4]
        for i in range(4):
            lane = big_state[i][:, o * Q : (o + 1) * Q]
            ok = ok & _all_q(F.equal(expected[..., i], lane))

    # ---- x = g * omega^rev(index), then the DEEP batching of the initial
    # polynomials (salt columns of a blinded oracle are not opened)
    x = F.mul(F.const(V1.GENERATOR), V1._exp_from_bits_rev(F, omega, bits))
    x_ext = (x, F.zeros(x.shape))
    alpha_b = _bq_ext(F, ch.fri_alpha)
    oracles = common.fri_oracles()
    salts = [common.salt_size(oracles[o][1]) for o in range(4)]
    zeta_vals = sum(
        (evs[o][: len(evs[o]) - salts[o]] for o in range(4)), [])
    zs_vals = evs[2][: common.config.num_challenges]
    summ = ext2.zero(F, x.shape)
    for point, vals, ro in (
        (zeta, zeta_vals, reduced_openings[0]),
        (zeta_next, zs_vals, reduced_openings[1]),
    ):
        reduced_evals = ext2.reduce_base_terms(F, alpha_b, vals)
        numerator = ext2.sub(F, reduced_evals, _bq_ext(F, ro))
        denominator = ext2.sub(F, x_ext, _bq_ext(F, point))
        summ = ext2.mul(F, ext2.pow_const(F, alpha_b, len(vals), x.shape), summ)
        summ = ext2.add(F, ext2.div(F, numerator, denominator), summ)
    prev_eval = summ

    # ---- fold phase, any constant arity: select-tree consistency check,
    # then barycentric interpolation at beta on the multiplicative coset
    cur_bits = bits
    for li, arity_bits in enumerate(fp.reduction_arity_bits):
        arity = 1 << arity_bits
        evals = pa[f"step_evals_{li}"]  # [B, Q, arity, 2]
        e = [(evals[..., j, 0], evals[..., j, 1]) for j in range(arity)]
        idx_bits = cur_bits[:arity_bits]  # LE: x_index_within_coset
        masks = [b != 0 for b in idx_bits]
        sel = e
        for m in masks:
            sel = [ext2.select(F, m, sel[2 * k + 1], sel[2 * k])
                   for k in range(len(sel) // 2)]
        ok = ok & _all_q(ext2.equal(F, prev_eval, sel[0]))

        beta = _bq_ext(F, ch.fri_betas[li])
        if arity_bits == 1:
            # 2-point interpolation at beta; g = -1
            e_0, e_1 = e
            coset_start = F.select(masks[0], F.neg(x), x)  # x * (-1)^b0
            a0 = (coset_start, F.zeros(x.shape))
            b0p = (F.neg(coset_start), F.zeros(x.shape))
            num = ext2.mul(F, ext2.sub(F, beta, a0), ext2.sub(F, e_1, e_0))
            den = ext2.sub(F, b0p, a0)
            prev_eval = ext2.add(F, ext2.div(F, num, den), e_0)
        else:
            # interpolate {(coset_start * g^i, eval_rev[i])} at beta, plonky2
            # compute_evaluation semantics. coset_start = x * g^{-rev(idx)};
            # evals reordered by in-coset bit reversal. Closed form:
            #   prod_j (beta - cs*g^j)        = beta^arity - cs^arity
            #   prod_{j!=i} (cs*g^i - cs*g^j) = arity * cs^(arity-1) * g^{-i}
            # => I(beta) = (beta^arity - cs^arity) / (arity * cs^(arity-1))
            #              * sum_i ev[i] * g^i / (beta - cs*g^i)
            g = V1.primitive_root(arity_bits)
            g_inv = pow(g, V1.P - 2, V1.P)
            coset_start = x
            for j in range(arity_bits):
                # rev(idx) bit j is idx_bits[arity_bits - 1 - j]
                c = F.const(pow(g_inv, 1 << j, V1.P), x.shape)
                coset_start = F.select(masks[arity_bits - 1 - j],
                                       F.mul(coset_start, c), coset_start)
            ev = [e[int(f"{i:0{arity_bits}b}"[::-1], 2)] for i in range(arity)]
            cs_ext = (coset_start, F.zeros(x.shape))
            cs_pow = ext2.pow_const(F, cs_ext, arity, x.shape)
            beta_pow = ext2.pow_const(F, beta, arity, x.shape)
            front = ext2.div(
                F,
                ext2.sub(F, beta_pow, cs_pow),
                ext2.mul(
                    F,
                    (F.const(arity, x.shape), F.zeros(x.shape)),
                    ext2.pow_const(F, cs_ext, arity - 1, x.shape),
                ),
            )
            total = ext2.zero(F, x.shape)
            for i in range(arity):
                gi = F.const(pow(g, i, V1.P), x.shape)
                x_i = (F.mul(coset_start, gi), F.zeros(x.shape))
                term = ext2.div(
                    F,
                    ext2.mul(F, ev[i], (gi, F.zeros(x.shape))),
                    ext2.sub(F, beta, x_i),
                )
                total = ext2.add(F, total, term)
            prev_eval = ext2.mul(F, front, total)

        # merkle proof of the coset leaf against commit-phase cap li
        coset_bits = cur_bits[arity_bits:]
        d_i = len(coset_bits) - cap_height
        sibs = pa[f"step_sibs_{li}"]  # [B, Q, d_i, 4]
        leaf = [c for ej in e for c in ej]  # flattened stored order
        siblings = [[sibs[..., d, i] for i in range(4)] for d in range(d_i)]
        cap_li = pa["commit_phase_caps"][:, li]
        state = pg.hash_or_noop(F, leaf, shape=tuple(leaf[0].shape), permute=perm)
        state = merkle_walk(F, state, coset_bits[:d_i], siblings, permute=perm)
        expected = _take_cap_b(F, cap_li, cap_index)
        for i in range(4):
            ok = ok & _all_q(F.equal(expected[..., i], state[i]))

        for _ in range(arity_bits):
            x = F.mul(x, x)
        x_ext = (x, F.zeros(x.shape))
        cur_bits = coset_bits

    final_coeffs = [
        _bq_ext(F, e) for e in V1._ext_list(F, pa["final_poly"])
    ]
    final_eval = ext2.reduce_with_powers(F, x_ext, final_coeffs)
    ok = ok & _all_q(ext2.equal(F, prev_eval, final_eval))
    return ok


def _take_cap_b(F, cap, idx):
    """cap [B, c, 4], idx int64 [B, Q] -> [B, Q, 4]."""
    return torch.gather(cap, 1, idx[..., None].expand(idx.shape + (4,)))
