"""What the batched plonky2 verifier shares with any other form of it:
array accessors, the opening order of the transcript, the vanishing
polynomial at zeta, and the flattening of a proof into named arrays.

Everything plonky2's verifier checks is computed directly on tensors:
the Fiat-Shamir challenge replay and the FRI checks live in
core/verifier_batched.py, the vanishing-polynomial identity here. All
control flow is static in the circuit shape (CommonData).
"""
from __future__ import annotations

import numpy as np

from ..ops import ext2
from ..ops.hashers import get_permute
from .gates import _se_stack, _se_unstack, selector_filter
from .rings import ExtRing
from .types import CommonData, Proof

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


class ProofChallenges:
    def __init__(self):
        self.plonk_betas = None
        self.plonk_gammas = None
        self.plonk_alphas = None
        self.plonk_zeta = None
        self.fri_alpha = None
        self.fri_betas = None
        self.fri_pow_response = None
        self.fri_query_indices = None


def _perm_for(F, common):
    """Transcript/Merkle permutation for the proof's hash config."""
    return get_permute(getattr(common.config, "hasher", "poseidon"), F)


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
    kis = F.from_u64(np.asarray(common.k_is, np.uint64))
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


# ---------------------------------------------------------------- top level
def proof_to_arrays(proof: Proof) -> dict:
    """Flatten a Proof into the named-array dict the verifier consumes."""
    pa = {
        "wires_cap": proof.wires_cap,
        "zs_pp_cap": proof.plonk_zs_partial_products_cap,
        "quotient_cap": proof.quotient_polys_cap,
        "open_constants": proof.openings.constants,
        "open_plonk_sigmas": proof.openings.plonk_sigmas,
        "open_wires": proof.openings.wires,
        "open_plonk_zs": proof.openings.plonk_zs,
        "open_plonk_zs_next": proof.openings.plonk_zs_next,
        "open_partial_products": proof.openings.partial_products,
        "open_quotient_polys": proof.openings.quotient_polys,
        "commit_phase_caps": proof.opening_proof.commit_phase_caps,
        "final_poly": proof.opening_proof.final_poly,
        "pow_witness": np.asarray(proof.opening_proof.pow_witness, dtype=np.uint64),
        "public_inputs": proof.public_inputs,
    }
    for o in range(4):
        pa[f"init_evals_{o}"] = proof.opening_proof.query_rounds.initial_evals[o]
        pa[f"init_sibs_{o}"] = proof.opening_proof.query_rounds.initial_siblings[o]
    for i in range(len(proof.opening_proof.query_rounds.step_evals)):
        pa[f"step_evals_{i}"] = proof.opening_proof.query_rounds.step_evals[i]
        pa[f"step_sibs_{i}"] = proof.opening_proof.query_rounds.step_siblings[i]
    return pa
