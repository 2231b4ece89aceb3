"""The table of peaks and the least time of a permutation, frozen here so
that no later change to the program can move them.

Peaks of one NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates, no
sparsity, at the full 700 W; the run prints the card's power limit beside
them):
  * 67e12 float32 FLOP/s outside the tensor cores: 132 SMs x 128 lanes x
    2 FLOP a fused multiply-add x 1.98 GHz. An SM's four schedulers dispatch
    one warp instruction a clock each, 128 thread instructions: at most
    67e12 / 2 = 33.5e12 thread instructions a second of any kind. That is
    the SIMT rate used below for integer work, and not the 64 INT32 lanes
    of an SM: integer multiply-adds dispatch to the FMA pipe beside the ALU
    pipe's adds, compares and logic, so a mix of the two can reach the
    dispatch rate, and only the dispatch rate bounds every mix;
  * 1,979e12 int8 tensor-core operations a second (a multiply-add is 2);
  * 3.35e12 bytes a second of HBM3.

A permutation's least time counts what its function needs, whatever
implements it (the hand counts of csrc/poseidon_gl.cu's and
csrc/poseidon_bn254.cu's arithmetic, per lane, in 32-bit instructions at
the unit costs given with each): its products can go to the tensor cores
as byte products (a 32 x 32-bit product is 16 int8 multiply-adds, a
32-bit word by an entry below 2^8 is 4), and everything else is SIMT
work. The least time is the largest of the SIMT work at the dispatch rate,
the products at the int8 tensor-core rate, and the state read and written
once at the HBM rate: a bound no implementation can beat, so a share of it
cannot pass 100 %.
"""
from __future__ import annotations

PEAK_SIMT_INSTR_PER_S = 67e12 / 2
PEAK_INT8_TC_OPS_PER_S = 1979e12
PEAK_HBM_BYTES_PER_S = 3.35e12
STATE_BYTES = 2 * 12 * 8           # 12 words in, 12 out

# Goldilocks Poseidon (t = 12, 8 full and 22 partial rounds, x^7), one lane:
#   field multiply: 4 products of 32-bit halves, 4 carry adds and a
#     12-instruction Goldilocks fold -> 16 SIMT;
#   round-constant add on any representative -> 9 SIMT;
#   dense MDS layer: 2 x 145 multiply-adds of the words' 32-bit halves by
#     the matrix's entries (below 2^6), then 12 recombine-and-folds of
#     about 10 -> 120 SIMT;
#   472 multiplies in the s-boxes (12 lanes in 8 full rounds, 1 in 22
#     partial, 4 multiplies an x^7), 129 constant adds (plonky2's
#     constants carried forward through the partial rounds), 30 dense
#     layers.
GL_SIMT = 472 * 16 + 129 * 9 + 30 * 120                       # 12,313
GL_TC_OPS = 2 * (472 * 4 * 16 + 30 * 290 * 4)                 # 130,016

# The BN254 bridge (3 Goldilocks words to one Fr element, t = 5, 8 full
# and 60 partial rounds, x^5, in Montgomery form), one lane, in the sparse
# form of csrc/poseidon_bn254.cu; w is a 64 x 64 -> 128-bit word product
# into a running sum, 4 products of 32-bit halves and 4 carry adds:
#   756 Fr products of 16 w (the MDS rows of the full rounds, the sparse
#     rows of the partial ones, the last matrix) -> 64 products, 64 SIMT;
#   100 x^5 of 2 squares (10 w, 12 shifts) and a product;
#   652 Montgomery reductions: 4 steps of m = t0 (-1/q) mod 2^64 (3
#     products) and m q (4 w), then a conditional subtraction (16 SIMT);
#   340 lazy Fr adds (8 SIMT); into Montgomery form 4 x 12 w; packing 4 x
#     (3 x 6 SIMT canonicalisations + 3 w); unpacking 4 x (6 folds of 12,
#     3 canonicalisations, 10 for the subtractions, 4 word products with
#     2 adds, 5 low products of 3 with 2 adds): 31 products, 152 SIMT.
BRIDGE_PRODUCTS = (756 * 64 + 100 * (2 * 40 + 64) + 4 * 48 + 652 * 76 + 4 * 12
                   + 4 * 31)                                  # 112,700
BRIDGE_SIMT = (756 * 64 + 100 * (2 * 52 + 64) + 4 * 48 + 652 * 80 + 340 * 8
               + 4 * 30 + 4 * 152)                            # 120,984
BRIDGE_TC_OPS = 2 * 16 * BRIDGE_PRODUCTS


def least_s(simt: float, tc_ops: float, state_bytes: float) -> float:
    return max(simt / PEAK_SIMT_INSTR_PER_S, tc_ops / PEAK_INT8_TC_OPS_PER_S,
               state_bytes / PEAK_HBM_BYTES_PER_S)


GL_PERMUTATION_S = least_s(GL_SIMT, GL_TC_OPS, STATE_BYTES)
BRIDGE_PERMUTATION_S = least_s(BRIDGE_SIMT, BRIDGE_TC_OPS, STATE_BYTES)
