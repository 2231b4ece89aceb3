"""The plonky2 proof verifier on tensors, a frozen copy of the port's plain
path: Fiat-Shamir challenge replay, the vanishing-polynomial identity at
zeta, and full FRI verification (Merkle walks, DEEP, folds, the final
polynomial and the proof of work).

`verify(F, common, vk_cap, circuit_digest, pa, batch=(B,))` checks B proofs
stacked along a leading axis of every array of `pa`: query vectors are
[B, Q], scalars [B], and the accept bits are bool[B]. All control flow is
static in the circuit shape (CommonData).

Two permutations, as in plonky2's config: `permute` is the config's Hasher,
used by the Fiat-Shamir transcript, the leaf hashes and the Merkle walks
(Goldilocks Poseidon, or the BN254 bridge under "bn254"); `inner_permute`
is the InnerHasher, used by the public-input hash only (Goldilocks Poseidon
under every config). verify.py passes both, to count their lanes and to run
them as CUDA graphs on a card.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ext2, fr_bn254, gl64
from . import poseidon_gl as pg
from .challenger import TapeChallenger, resolve_challenges
from .gates import _se_stack, _se_unstack, selector_filter
from .merkle import merkle_walk
from .rings import ExtRing
from .types import CommonData

GENERATOR = 7  # multiplicative group generator of Goldilocks
P = 0xFFFFFFFF00000001
ORDER = 0xFFFFFFFF00000000  # p - 1


def _g_pow(e: int) -> int:
    return pow(GENERATOR, e % (P - 1), P)


def primitive_root(bits: int) -> int:
    return _g_pow(ORDER >> bits)


def _ext_list(F, arr2):
    """[..., n, 2] ext tensor -> list of n (c0, c1)."""
    n = arr2.shape[-2]
    return [(arr2[..., i, 0], arr2[..., i, 1]) for i in range(n)]


def _scalar_list(F, arr):
    return [arr[..., i] for i in range(arr.shape[-1])]


CHALLENGE_FIELDS = ("plonk_betas", "plonk_gammas", "plonk_alphas", "plonk_zeta",
                    "fri_alpha", "fri_betas", "fri_pow_response",
                    "fri_query_indices")


class ProofChallenges:
    def __init__(self, **fields):
        for f in CHALLENGE_FIELDS:
            setattr(self, f, fields.get(f))


def bridge_permute(F, state):
    """The BN254 bridge permutation of a stacked state int64[12, ...]."""
    return fr_bn254.permute12_bridge(state)


def _perm_for(F, common):
    """Transcript/Merkle permutation for the proof's hash config: plonky2's
    PoseidonGoldilocksConfig ("poseidon") or Bn254PoseidonGoldilocksConfig
    ("bn254"); the public-input hash is Goldilocks Poseidon under both."""
    name = getattr(common.config, "hasher", "poseidon")
    if name in (None, "poseidon"):
        return pg.permute
    if name == "bn254":
        return bridge_permute
    raise ValueError(f"unknown hasher config: {name}")


def _digest_rows(F, cap):
    """cap [..., c, 4] -> list of c digests of 4 elements."""
    return [[cap[..., r, i] for i in range(4)] for r in range(cap.shape[-2])]


def get_challenges(F, common: CommonData, pa: dict, pi_hash, circuit_digest,
                   permute=None, batch=()):
    """Replay of plonky2's challenger schedule. The duplex schedule is
    recorded and then run as a plain loop of permutations of [12, *batch]
    (see TapeChallenger); the verifying key's digest, which has no batch
    axis, is broadcast."""
    ch = ProofChallenges()
    nc = common.config.num_challenges
    c = TapeChallenger(F, shape=batch, permute=permute or _perm_for(F, common))
    for e in _scalar_list(F, circuit_digest):
        c.observe_element(e.expand(batch))
    for e in pi_hash:
        c.observe_element(e)
    c.observe_cap(_digest_rows(F, pa["wires_cap"]))
    ch.plonk_betas = c.get_n_challenges(nc)
    ch.plonk_gammas = c.get_n_challenges(nc)
    c.observe_cap(_digest_rows(F, pa["zs_pp_cap"]))
    ch.plonk_alphas = c.get_n_challenges(nc)
    c.observe_cap(_digest_rows(F, pa["quotient_cap"]))
    ch.plonk_zeta = c.get_extension_challenge()
    flat = [
        x for b in _opening_batches(F, pa) for e in b for x in (e[0], e[1])
    ]
    c.observe_elements(flat)
    ch.fri_alpha = c.get_extension_challenge()
    ch.fri_betas = []
    caps = pa["commit_phase_caps"]  # [..., layers, c, 4]
    for i in range(caps.shape[-3]):
        c.observe_cap(_digest_rows(F, caps[..., i, :, :]))
        ch.fri_betas.append(c.get_extension_challenge())
    c.observe_elements(
        [x for e in _ext_list(F, pa["final_poly"]) for x in (e[0], e[1])]
    )
    c.observe_element(pa["pow_witness"])
    ch.fri_pow_response = c.get_challenge()
    ch.fri_query_indices = c.get_n_challenges(
        common.config.fri_config.num_query_rounds)
    vals = c.finalize()
    for f in CHALLENGE_FIELDS:
        setattr(ch, f, resolve_challenges(getattr(ch, f), vals))
    return ch


def _opening_batches(F, pa):
    """Openings in transcript order (plonky2 `OpeningSet::to_fri_openings`)."""
    zeta_batch = (
        _ext_list(F, pa["open_constants"])
        + _ext_list(F, pa["open_plonk_sigmas"])
        + _ext_list(F, pa["open_wires"])
        + _ext_list(F, pa["open_plonk_zs"])
        + _ext_list(F, pa["open_partial_products"])
        + _ext_list(F, pa["open_quotient_polys"])
    )
    zeta_next_batch = _ext_list(F, pa["open_plonk_zs_next"])
    return [zeta_batch, zeta_next_batch]


# --------------------------------------------------------------- vanishing
def eval_vanishing_poly(F, common: CommonData, ch, pa, pi_hash):
    """The vanishing polynomial's constraint terms at zeta, reduced with
    each alpha (plonky2 `eval_vanishing_poly`). Returns (one ext value per
    challenge round, zeta^degree)."""
    R = ExtRing(F)
    nc = common.config.num_challenges
    num_prods = common.num_partial_products
    qdf = common.quotient_degree_factor

    zeta = ch.plonk_zeta
    zeta_pow_deg = R.exp_power_of_2(zeta, common.degree_bits)

    local_constants = _ext_list(F, pa["open_constants"])
    local_wires = _ext_list(F, pa["open_wires"])
    local_zs = _ext_list(F, pa["open_plonk_zs"])
    next_zs = _ext_list(F, pa["open_plonk_zs_next"])
    s_sigmas = _ext_list(F, pa["open_plonk_sigmas"])
    partial_products = _ext_list(F, pa["open_partial_products"])

    pi_hash_ext = [R.from_base(h) for h in pi_hash]

    combined = _gate_constraints_stacked(
        F, R, common, local_constants, local_wires, pi_hash_ext)

    # L_0(zeta) = (zeta^n - 1) / (n (zeta - 1))
    one = R.one()
    zero_poly = R.sub(zeta_pow_deg, one)
    n_const = R.const(common.degree)
    denom = R.mul(n_const, R.sub(zeta, one))
    l_0 = R.div(zero_poly, denom)

    # all k_i * zeta lanes with two stacked base muls
    k_is = tuple(common.k_is)
    kis = gl64.table(("k_is", k_is), F.device, lambda: np.asarray(k_is, np.uint64))
    kis = kis.reshape((len(common.k_is),) + (1,) * zeta[0].dim())
    s_ids_st = (F.mul(kis, zeta[0]), F.mul(kis, zeta[1]))

    vanishing_z_1_terms = []
    vanishing_pp_terms = []
    nr = common.config.num_routed_wires
    assert nr % qdf == 0, "routed wires must split into whole product chunks"
    wires_st = _se_stack(F, local_wires[:nr])
    sigm_st = _se_stack(F, s_sigmas)
    for i in range(nc):
        z_x = local_zs[i]
        z_gx = next_zs[i]
        vanishing_z_1_terms.append(R.sub(R.mul(l_0, z_x), l_0))
        beta = R.from_base(ch.plonk_betas[i])
        gamma = R.from_base(ch.plonk_gammas[i])
        cur_partials = partial_products[i * num_prods : (i + 1) * num_prods]
        accs = [z_x] + cur_partials + [z_gx]
        # wires/sigma/s_id lanes stacked: one ext op per formula step
        wpg = ext2.add(F, wires_st, gamma)
        nume = ext2.add(F, ext2.mul(F, beta, s_ids_st), wpg)
        deno = ext2.add(F, ext2.mul(F, beta, sigm_st), wpg)
        nume_p = _chunk_prod(F, nume, qdf)  # [nr/qdf, ...]
        deno_p = _chunk_prod(F, deno, qdf)
        for k in range(nr // qdf):
            np_k = (nume_p[0][k], nume_p[1][k])
            dp_k = (deno_p[0][k], deno_p[1][k])
            # prev_acc * nume - next_acc * denom
            vanishing_pp_terms.append(
                R.sub(R.mul(accs[k], np_k), R.mul(accs[k + 1], dp_k))
            )

    all_terms = vanishing_z_1_terms + vanishing_pp_terms + combined
    out = []
    for alpha in ch.plonk_alphas:
        out.append(R.reduce_with_powers(R.from_base(alpha), all_terms))
    return out, zeta_pow_deg


def _gate_constraints_stacked(F, R, common, local_constants, local_wires, pi_hash_ext):
    """filter * constraints accumulated on a stacked lane axis: one ext
    mul_add per gate instead of one per constraint."""
    num_selectors = common.selectors_info.num_selectors
    ngc = common.num_gate_constraints
    shape = tuple(local_wires[0][0].shape)
    combined = (F.zeros((ngc,) + shape), F.zeros((ngc,) + shape))
    zero = (F.zeros(shape), F.zeros(shape))
    for i, gate in enumerate(common.gates):
        si = common.selectors_info.selector_indices[i]
        group = range(*common.selectors_info.groups[si])
        filt = selector_filter(R, si, group, num_selectors, i, local_constants)
        cs = gate.eval_unfiltered(
            R, local_constants[num_selectors:], local_wires, pi_hash_ext)
        if not cs:
            continue
        cs = cs + [zero] * (ngc - len(cs))
        cst = _se_stack(F, cs)
        combined = ext2.add(F, ext2.mul(F, filt, cst), combined)
    return _se_unstack(F, combined)


def _chunk_prod(F, se, qdf):
    """Product along chunks of size qdf of a stacked ext tensor [n, ...]."""
    n = se[0].shape[0]
    k = n // qdf
    sh = tuple(se[0].shape[1:])
    c0 = se[0].reshape((k, qdf) + sh)
    c1 = se[1].reshape((k, qdf) + sh)
    acc = (c0[:, 0], c1[:, 0])
    for j in range(1, qdf):
        acc = ext2.mul(F, acc, (c0[:, j], c1[:, j]))
    return acc


# --------------------------------------------------------------------- FRI
def _exp_from_bits_rev(F, base: int, bits):
    """base ** (sum_i bits[i] * 2^(n-1-i)), i.e. base^(bit-reversed index)."""
    n = len(bits)
    acc = F.ones(tuple(bits[0].shape))
    for i, b in enumerate(bits):
        factor = F.const(pow(base, 1 << (n - 1 - i), P))
        acc = F.mul(acc, F.select(b != 0, factor, F.ones()))
    return acc


def _lift_ext(e):
    """Lift a per-proof ext element [*batch] to broadcast against [*batch, Q]."""
    return (e[0][..., None], e[1][..., None])


def _all_queries(mask):
    """Reduce bool [*batch, Q] over the query axis."""
    return mask.all(dim=-1)


def _take_cap(cap, idx):
    """cap [*batch, c, 4], idx int64 [*batch, Q] -> [*batch, Q, 4]."""
    return torch.gather(cap, -2, idx[..., None].expand(tuple(idx.shape) + (4,)))


def verify_fri(F, common: CommonData, ch, pa, vk_cap, reduced_openings, zeta,
               zeta_next, ok, permute=None, batch=()):
    """FRI verification; the query lanes trail the batch axes: [*batch, Q]."""
    perm = permute or _perm_for(F, common)
    fp = common.fri_params
    lde_bits = fp.lde_bits
    cap_height = fp.config.cap_height
    pow_bits = fp.config.proof_of_work_bits

    # proof of work: the top `pow_bits` bits of the canonical response are 0
    pw = ch.fri_pow_response
    for i in range(64 - pow_bits, 64):
        ok = ok & (F.bit(pw, i) == 0)

    omega = primitive_root(lde_bits)
    xi = F.stack(ch.fri_query_indices, axis=-1)  # [*batch, Q]
    bits = [F.bit(xi, i) for i in range(lde_bits)]
    cap_index = torch.zeros_like(bits[0])  # int64, as torch.gather wants
    for k, b in enumerate(bits[lde_bits - cap_height:]):
        cap_index = cap_index + (b << k)

    # ---- initial tree proofs: leaf-hash each oracle, then ONE merged path
    # walk over 4*Q lanes (the 4 oracle trees share depth and index bits)
    depth = lde_bits - cap_height
    # the verifying key's cap has no batch axis: lift it
    caps = [vk_cap.expand(tuple(batch) + tuple(vk_cap.shape)),
            pa["wires_cap"], pa["zs_pp_cap"], pa["quotient_cap"]]
    evs = [_scalar_list(F, pa[f"init_evals_{o}"]) for o in range(4)]  # [*batch, Q] each
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
        expected = _take_cap(caps[o], cap_index)  # [*batch, Q, 4]
        for i in range(4):
            lane = big_state[i][..., o * Q : (o + 1) * Q]
            ok = ok & _all_queries(F.equal(expected[..., i], lane))

    # ---- x = g * omega^rev(index), then the DEEP batching of the initial
    # polynomials (salt columns of a blinded oracle are not opened)
    x = F.mul(F.const(GENERATOR), _exp_from_bits_rev(F, omega, bits))
    x_ext = (x, F.zeros(x.shape))
    alpha_b = _lift_ext(ch.fri_alpha)
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
        numerator = ext2.sub(F, reduced_evals, _lift_ext(ro))
        denominator = ext2.sub(F, x_ext, _lift_ext(point))
        summ = ext2.mul(F, ext2.pow_const(F, alpha_b, len(vals), x.shape), summ)
        summ = ext2.add(F, ext2.div(F, numerator, denominator), summ)
    prev_eval = summ

    # ---- fold phase, any constant arity: select-tree consistency check,
    # then barycentric interpolation at beta on the multiplicative coset
    cur_bits = bits
    for li, arity_bits in enumerate(fp.reduction_arity_bits):
        arity = 1 << arity_bits
        evals = pa[f"step_evals_{li}"]  # [*batch, Q, arity, 2]
        e = [(evals[..., j, 0], evals[..., j, 1]) for j in range(arity)]
        idx_bits = cur_bits[:arity_bits]  # LE: x_index_within_coset
        masks = [b != 0 for b in idx_bits]
        sel = e
        for m in masks:
            sel = [ext2.select(F, m, sel[2 * k + 1], sel[2 * k])
                   for k in range(len(sel) // 2)]
        ok = ok & _all_queries(ext2.equal(F, prev_eval, sel[0]))

        beta = _lift_ext(ch.fri_betas[li])
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
            g = primitive_root(arity_bits)
            g_inv = pow(g, P - 2, P)
            coset_start = x
            for j in range(arity_bits):
                # rev(idx) bit j is idx_bits[arity_bits - 1 - j]
                c = F.const(pow(g_inv, 1 << j, P), x.shape)
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
                gi = F.const(pow(g, i, P), x.shape)
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
        sibs = pa[f"step_sibs_{li}"]  # [*batch, Q, d_i, 4]
        leaf = [c for ej in e for c in ej]  # flattened stored order
        siblings = [[sibs[..., d, i] for i in range(4)] for d in range(d_i)]
        cap_li = pa["commit_phase_caps"][..., li, :, :]
        state = pg.hash_or_noop(F, leaf, shape=tuple(leaf[0].shape), permute=perm)
        state = merkle_walk(F, state, coset_bits[:d_i], siblings, permute=perm)
        expected = _take_cap(cap_li, cap_index)
        for i in range(4):
            ok = ok & _all_queries(F.equal(expected[..., i], state[i]))

        for _ in range(arity_bits):
            x = F.mul(x, x)
        x_ext = (x, F.zeros(x.shape))
        cur_bits = coset_bits

    final_coeffs = [
        _lift_ext(e) for e in _ext_list(F, pa["final_poly"])
    ]
    final_eval = ext2.reduce_with_powers(F, x_ext, final_coeffs)
    ok = ok & _all_queries(ext2.equal(F, prev_eval, final_eval))
    return ok


# ---------------------------------------------------------------- top level
def _quotient_check(F, common, pa, vanishing, zeta_pow_deg):
    """vanishing(zeta) == Z_H(zeta) * quotient(zeta), per challenge round."""
    R = ExtRing(F)
    ok = None
    z_h_zeta = R.sub(zeta_pow_deg, R.one())
    quotient_list = _ext_list(F, pa["open_quotient_polys"])
    qdf = common.quotient_degree_factor
    for i in range(common.config.num_challenges):
        chunk = quotient_list[i * qdf : (i + 1) * qdf]
        recombined = R.reduce_with_powers(zeta_pow_deg, chunk)
        eq = ext2.equal(F, vanishing[i], R.mul(z_h_zeta, recombined))
        ok = eq if ok is None else (ok & eq)
    return ok


def phase_challenges(F, common: CommonData, circuit_digest, pa: dict,
                     permute=None, batch=(), inner_permute=None):
    """Phase 1: public-input hash + Fiat-Shamir replay. Returns (pi_hash,
    the challenges as a dict of lists and tuples of tensors)."""
    # the public-input hash is plonky2's InnerHasher: Goldilocks Poseidon
    # under every config, whatever the transcript's permutation is
    pi_hash = pg.hash_no_pad(F, _scalar_list(F, pa["public_inputs"]),
                             shape=tuple(batch),
                             permute=inner_permute or pg.permute)
    ch = get_challenges(F, common, pa, pi_hash, circuit_digest,
                        permute=permute, batch=batch)
    return pi_hash, {f: getattr(ch, f) for f in CHALLENGE_FIELDS}


def phase_vanishing(F, common: CommonData, pa: dict, pi_hash, ch_tree):
    """Phase 2: vanishing polynomial at zeta + quotient recombination."""
    vanishing, zeta_pow_deg = eval_vanishing_poly(
        F, common, ProofChallenges(**ch_tree), pa, pi_hash)
    return _quotient_check(F, common, pa, vanishing, zeta_pow_deg)


def phase_fri(F, common: CommonData, vk_cap, pa: dict, ch_tree, ok,
              permute=None, batch=()):
    """Phase 3: DEEP reduced openings + full FRI verification."""
    ch = ProofChallenges(**ch_tree)
    reduced_openings = [ext2.reduce_with_powers(F, ch.fri_alpha, b)
                        for b in _opening_batches(F, pa)]
    g_zeta = F.const(_g_pow(ORDER >> common.degree_bits))
    zeta_next = ext2.scalar_mul(F, ch.plonk_zeta, g_zeta)
    return verify_fri(F, common, ch, pa, vk_cap, reduced_openings,
                      ch.plonk_zeta, zeta_next, ok, permute=permute, batch=batch)


def verify(F, common: CommonData, vk_cap, circuit_digest, pa: dict,
           permute=None, batch=(), inner_permute=None, quotient=True):
    """Verify one proof (or, with `batch=(B,)`, B proofs stacked along a
    leading axis); returns the accept bit as a bool tensor of shape `batch`.

    `pa` values are int64 tensors (see arrays_to_backend); `vk_cap` is a
    [cap, 4] tensor, `circuit_digest` a [4] tensor. `quotient=False` skips
    the vanishing polynomial and the quotient check: a broken verifier,
    for the tests that the comparison sees that layer."""
    pi_hash, ch_tree = phase_challenges(F, common, circuit_digest, pa,
                                        permute=permute, batch=batch,
                                        inner_permute=inner_permute)
    if quotient:
        ok = phase_vanishing(F, common, pa, pi_hash, ch_tree)
    else:
        ok = torch.ones(tuple(batch), dtype=torch.bool, device=pi_hash[0].device)
    return phase_fri(F, common, vk_cap, pa, ch_tree, ok,
                     permute=permute, batch=batch)
