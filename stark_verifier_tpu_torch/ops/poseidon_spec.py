"""Optimized-Poseidon parameter derivation (fast partial rounds).

Derives, from the 360 ALL_ROUND_CONSTANTS and the circulant + diagonal MDS
matrix alone, the five FAST_PARTIAL_* tables of plonky2's optimized
partial-round schedule (plonky2's poseidon.rs). The port's copied tables in
`_poseidon_gl_constants.py` are data; `poseidon_kernel.schedule_tables()`
uploads the first two of them to every Poseidon kernel, and this module
makes all five re-derivable (tests/test_torch_poseidon_spec.py holds them
equal). Pure python ints, host only.

The two standard transformations (Poseidon paper App. B; the hadeshash
`poseidonperm_x3_64_24_optimized.sage` plonky2 cites):

1. **Equivalent round constants.** In the naive schedule every partial
   round r adds a full 12-wide constant vector before its single sbox.
   Pulling round r+1's vector back through the MDS (c · M^-1, row-vector
   convention) splits it: coordinate 0 cannot cross the sbox and remains as
   a scalar added right after it (FAST_PARTIAL_ROUND_CONSTANTS), while
   coordinates 1..11 commute with the coordinate-0 sbox and merge into
   round r's vector. Sweeping from the last partial round to the first
   accumulates everything into one vector added before the first partial
   sbox (FAST_PARTIAL_FIRST_ROUND_CONSTANT).

2. **Sparse matrix factorization.** With M the row-vector MDS (s' = s·M),
   every M_k in the evolving product factors as
   M_k = (1 ⊕ M̂_k) · S_k with S_k = [[M00, v_k], [ŵ_k, I]] sparse
   (ŵ_k = M̂_k^{-1} · w_k). The block-diagonal factor commutes with the
   coordinate-0 sbox, so it migrates left through the whole partial span:
   per-round work becomes one sparse multiply (FAST_PARTIAL_ROUND_W_HATS /
   _VS rows, applied first-round-last in collection order) plus a single
   dense 11x11 initial matrix (FAST_PARTIAL_ROUND_INITIAL_MATRIX) applied
   before the first partial sbox. The evolution is M_{k+1} = M · (1 ⊕ M̂_k),
   whose top-left entry stays M00 = CIRC[0] + DIAG[0].
"""
from __future__ import annotations

from typing import List, Tuple

from ._poseidon_gl_constants import (
    ALL_ROUND_CONSTANTS,
    HALF_N_FULL_ROUNDS,
    MDS_MATRIX_CIRC,
    MDS_MATRIX_DIAG,
    N_PARTIAL_ROUNDS,
    WIDTH,
)

P = 0xFFFFFFFF00000001
T = WIDTH
R_P = N_PARTIAL_ROUNDS
R_F_HALF = HALF_N_FULL_ROUNDS


# ------------------------------------------------------- exact mod-p algebra
def mds_row_vector_matrix() -> List[List[int]]:
    """The MDS matrix in row-vector convention (s' = s·M), i.e. the
    transpose of the per-output-row circulant plonky2 applies:
    M[j][r] = CIRC[(j - r) mod 12] + (j == r) * DIAG[r]."""
    m = [[0] * T for _ in range(T)]
    for j in range(T):
        for r in range(T):
            m[j][r] = int(MDS_MATRIX_CIRC[(j - r) % T]) % P
        m[j][j] = (m[j][j] + int(MDS_MATRIX_DIAG[j])) % P
    return m


def mat_mul(a, b):
    n, k, m = len(a), len(b), len(b[0])
    out = [[0] * m for _ in range(n)]
    for i in range(n):
        ai = a[i]
        for j in range(m):
            out[i][j] = sum(ai[l] * b[l][j] for l in range(k)) % P
    return out


def mat_inv(a):
    """Gauss-Jordan inverse mod P (exact python ints)."""
    n = len(a)
    aug = [[x % P for x in row] + [int(i == r) for i in range(n)]
           for r, row in enumerate(a)]
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r][col] % P != 0)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], P - 2, P)
        aug[col] = [(x * inv) % P for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(x - f * y) % P for x, y in zip(aug[r], aug[col])]
    return [row[n:] for row in aug]


def vec_mat(v, m):
    return [sum(v[i] * m[i][j] for i in range(len(v))) % P for j in range(len(m[0]))]


# ------------------------------------------------------------ the derivation
def derive_equivalent_constants() -> Tuple[List[int], List[int]]:
    """Returns (FAST_PARTIAL_FIRST_ROUND_CONSTANT[12],
    FAST_PARTIAL_ROUND_CONSTANTS[22])."""
    m_inv = mat_inv(mds_row_vector_matrix())
    rc = [[int(ALL_ROUND_CONSTANTS[r * T + i]) % P for i in range(T)]
          for r in range(len(ALL_ROUND_CONSTANTS) // T)]
    first_partial = R_F_HALF  # round 4
    last_partial = R_F_HALF + R_P - 1  # round 25
    partial_scalars = [0] * R_P
    # Sweep backward: pull round i+1's vector to before round i's MDS;
    # coordinate 0 stays after round i's sbox, the rest joins round i's
    # pre-sbox vector. Rounds 5..25 end up with scalar-only constants.
    for i in range(last_partial - 1, first_partial - 1, -1):
        pulled = vec_mat(rc[i + 1], m_inv)
        rc[i] = [rc[i][0]] + [(a + b) % P for a, b in zip(rc[i][1:], pulled[1:])]
        rc[i + 1] = [pulled[0]] + [0] * (T - 1)
    for i in range(first_partial + 1, last_partial + 1):
        partial_scalars[i - first_partial - 1] = rc[i][0]
        assert all(x == 0 for x in rc[i][1:])
    # The last partial round has no post-sbox constant (the final full
    # rounds' constant layer is applied unchanged): table entry 21 is 0.
    partial_scalars[R_P - 1] = 0
    return rc[first_partial], partial_scalars


def derive_equivalent_matrices() -> Tuple[List[int], List[int], List[int]]:
    """Returns (FAST_PARTIAL_ROUND_INITIAL_MATRIX[11*11] row-major,
    FAST_PARTIAL_ROUND_W_HATS[22*11], FAST_PARTIAL_ROUND_VS[22*11]).

    Iteration k: factor the evolving M_k = (1 ⊕ M̂_k)·S_k, collect S_k's
    (w_hat, v); evolve M_{k+1} = M·(1 ⊕ M̂_k). The sparse rounds are applied
    in REVERSE collection order (the factor of the original M lands on the
    last partial round), and the final block-diagonal residue (1 ⊕ M̂_last)
    is the initial matrix applied before the first partial sbox."""
    M = mds_row_vector_matrix()
    m_mul = M
    w_hats, vs = [], []
    m_hat = None
    for _ in range(R_P):
        m_hat = [row[1:] for row in m_mul[1:]]
        w = [m_mul[r][0] for r in range(1, T)]
        v = m_mul[0][1:]
        vs.append(list(v))
        m_hat_inv = mat_inv(m_hat)
        w_hats.append([sum(m_hat_inv[i][j] * w[j] for j in range(T - 1)) % P
                       for i in range(T - 1)])
        block = [[int(i == j) for j in range(T)] for i in range(T)]
        for i in range(T - 1):
            for j in range(T - 1):
                block[i + 1][j + 1] = m_hat[i][j]
        m_mul = mat_mul(M, block)
    initial = [m_hat[i][j] for i in range(T - 1) for j in range(T - 1)]
    w_hats_flat = [x for row in reversed(w_hats) for x in row]
    vs_flat = [x for row in reversed(vs) for x in row]
    return initial, w_hats_flat, vs_flat


def derive_fast_partial_tables() -> dict:
    first_rc, partial_rcs = derive_equivalent_constants()
    initial, w_hats, vs = derive_equivalent_matrices()
    return {
        "FAST_PARTIAL_FIRST_ROUND_CONSTANT": first_rc,
        "FAST_PARTIAL_ROUND_CONSTANTS": partial_rcs,
        "FAST_PARTIAL_ROUND_INITIAL_MATRIX": initial,
        "FAST_PARTIAL_ROUND_W_HATS": w_hats,
        "FAST_PARTIAL_ROUND_VS": vs,
    }
