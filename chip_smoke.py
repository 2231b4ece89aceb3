#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA card (built for Hopper, sm_90a), `nvcc`, and no network. It

  1. names the device;
  2. builds every hand-written kernel from the sources in this checkout
     (one nvcc a source, all started together) and prints, one line a
     kernel, the registers and spill bytes ptxas reported for it; loads
     each library onto the card and times an empty kernel's launch from a
     CUDA graph (the launch floor, `launch_floor_ms` of every kernel row:
     no launch is shorter);
  3. holds the five field kernels of csrc/field.cu (gl64's mul, add, sub,
     mul_add, mul_small: one launch a call on every path) word for word
     against their plain versions on the card and on the CPU, edge words in
     every operand, in every operand form the paths give (equal, broadcast,
     0-dim, strided, gl64.neg's null operand) at 0 to 2^24 elements, and
     times them from a CUDA graph beside their bounds, with the wrapper's
     host time a call; then each other kernel against its plain PyTorch
     version on the card (the plain versions built from gl64 ops launch
     field kernels there, and their times include those launches), at the
     lane counts the paths give it and, for the two rate probes, on the
     card-filling tensors they are timed on (exact equality: this is modular
     arithmetic; the one float chain of the rate probe has a stated
     tolerance), the three Poseidon kernels against each other too (each
     kernel's two grids on both sides of the lane count that picks between
     them), and times them, the Poseidon kernels in turns at
     every lane count a verifier path launches them at, each beside its
     bound there (as device time: launches replayed from a CUDA graph); the
     probes' launches are counted over their timed loop,
     which is their path: no verifier path launches them, and that is
     checked;
  4. drives the main path: 64 distinct zero-knowledge Semaphore proofs
     (2^20-member set, 135 wires, 28 FRI queries) tiled to a batch of 1024,
     through load_proofs -> batched_arrays -> make_verifier_fn_batched on
     the card, once per Poseidon kernel variant (mxu = 0, 1, 2); checks that
     all are accepted, that corrupted lanes and only those are rejected,
     that the selected kernel's launch count equals the number of
     permutation calls the path makes (136 of 1,024 lanes, 57 of 28,672
     and 8 of 114,688, by a wrapper that records each call's lane count)
     and the other kernels' is 0, that every division launched the
     inverse kernel (7 ext2_inv launches a batch), that the field kernels
     launched exactly ZK20_FIELD_LAUNCHES a batch, that
     accept bits and challenges are equal across the variants, and that
     they equal the same path run with the plain permutation on the card
     and on the CPU;
  5. drives the per-proof entry points (make_verifier_fn and
     make_verifier_fn_phased) on the first proofs of the fixture under each
     variant: accepted, a corrupted proof rejected, bits equal to the
     batched path's, kernels launched at 1, 28 and 112 lanes;
  6. holds the BN254 bridge kernel (bridge_permute12) against its plain
     version on the card at every lane count the wrapped path gives it,
     edge values in every state position, and times it;
  7. drives the bn254-wrapped path: the 16 proofs of the wrapper circuit
     (degree 2^13, 28 queries, the BN254 bridge as transcript and Merkle
     hash) tiled to a batch of 256 through make_verifier_fn_batched on the
     card: all accepted, corrupted lanes and only those rejected, 230
     bridge launches and 2 Poseidon launches a batch (the public-input
     hash), 11 ext2_inv launches, the field kernels' WRAPPED_FIELD_LAUNCHES
     and no other kernel, challenges equal to the CPU path's, proof 0
     through make_verifier_fn with the same bit, and ms a batch;
  8. drives the compiled verifier (models/flagship.compiled_verifier, a
     CUDA graph captured once and replayed) on both batches, zk20 (1024,
     mode "batched") and wrapped (256): one eager batch first under
     torch.cuda.set_sync_debug_mode("error") (no host sync on the path),
     then the capture, which counts the eager batch's launches exactly
     (the inverse kernel's and the field kernels' among them),
     its capture and instantiate seconds, the graph's node count (below
     30,000 for zk20 and 35,000 for wrapped: about one node a launch) and peak
     device bytes; the clean and the corrupted batch replayed through one
     graph with accept bits equal to the eager path's (the corrupted lanes,
     and only those, rejected), no launch counted on the host by a replay,
     ms a batch (median of 5 replays) beside the eager ms; mode "vmap" on
     the first 4 zk20 proofs, clean and with proof 2 corrupted, equal to the
     batched path's bits; a dict of another shape refused;
  9. drives the multi-rank verifier on a world of one rank (NCCL): the zk20
     batch of 1024 through make_sharded_verifier (batch in lanes), clean and
     corrupted, with its accept count and the digest chain (3,072
     permutations of one lane, counted), the digest equal to the same chain
     run on the CPU with the plain permutation; make_batch_verifier on 16
     proofs;
 10. holds the NTT kernels of csrc/ntt.cu (ntt_tile, ntt_stride: one
     launch for each ntt, intt, coset_fft, coset_ifft and coset_lde up to
     2^12 points, two up to 2^17, one more a stage range above) word for
     word against the plain versions on the card and on the CPU, all five
     functions at 2 to 2^17 points on 1 and 7 rows, at 2^18 on one row and
     at 1,080 rows of 2^13, ntt and intt at 2^19 to 2^25 points on one row
     (against the card's plain version; the CPU's at 2^23 for ntt;
     intt(ntt(x)) == x), edge words in the input, launches counted a call
     against the geometry's; prints ntt_stride's ptxas line; checks
     coset_lde (rate 3, shift 7) of the prover's three degree-2^13 shapes
     ([1080 | 160 | 128, 2^13] -> 2^16 points a row) against the numpy
     oracle, intt(ntt(x)) == x, and ntt_4step on the one-rank world equal to
     ntt; times every transform shape the provers make (each kernel alone
     and the transform) beside the bounds, the launch floor and the plain
     version's time, and the widest LDE's peak bytes;
 11. turns proof 0 of the zk20 and of the wrapped fixture into plonky2's
     bytes and JSON and back, verifies the decoded proofs on the card (a
     flipped opening rejected), and checks that bytes decoded with the other
     circuit's CommonData raise;
 12. proves on the card: a 2^20-member access set (its keys hashed in one
     Poseidon launch of 2^20 lanes, its tree of 20 levels; the root equal
     to the same tree built with the plain permutation, 8 Merkle paths
     verified), the Semaphore circuit (degree 2^9, 135 wires, its verifying
     key equal to the CPU build's), 64 distinct signals at the Semaphore
     preset through prove_batch (proofs a second, ms by stage, Poseidon
     launches by lane count, peak device bytes), all 64 accepted by the
     batched verifier on the card and a flipped opening rejected, and
     AccessSet.verify_signals_np on the card accepting a signal and
     rejecting one with a changed topic; the 64 signals proved again with
     max_lanes=32 equal, proof by proof, two proves of 32 from the same
     generators (the quotient's PoseidonGate constraints in one
     poseidon_gate_eval launch, the inverses in gl_inv and ext2_inv
     launches; the field kernels' launches pinned, PROVE_FIELD_LAUNCHES,
     and the NTT kernels', one or two a transform);
     2 signals proved with the kernel,
     with the plain permutation on the card and on the CPU (a spawned
     process beside the card's work) give equal proofs,
     whose grind witnesses are the lowest a CPU scan finds; the three
     Poseidon kernels held against the plain version and timed at the
     prover's widest lane counts (262,144, 524,288, 1,048,576);
 13. runs recursion on the card, on the prove phase's set and signals:
     the two witness kernels (poseidon_gate_fill, ext2_reduce_chain)
     against their plain versions at 1 to 1,025 lanes and 1 to 100 chain
     steps, across the chain's chunks of 32 (edge words, non-canonical swap
     bits, base and extension coefficients), and the other four kernels of
     witness.cu (ext2_arith under 25 constant pairs, gl_inv, ext2_inv on
     every pair of edge words, poseidon_gate_eval on the quotient's planes
     and on honest wires), all timed at the lane counts the paths launch
     them at, each beside its bound and the launch floor; the
     bn254 wrapper of the zk20 circuit built on the card, its CommonData and verifying key equal
     to sem_wrapped16.npz's, the fixture's first 16 zk20 proofs wrapped in
     one prove_batch (stage ms, proofs a second, peak bytes, launches by
     lane count of the bridge, Poseidon and witness.cu's kernels: one
     ext2_arith a generator, one poseidon_gate_eval; the NTT kernels' one
     or two a transform), every
     wrapped proof equal to the fixture's array by array, all accepted by
     the batched verifier on the card and a corrupted lane rejected, a child
     with a flipped opening refused with WitnessConflict;
     AccessSet.verify_signal True for a signal, False with a flipped opening
     and with a forged nullifier; 4 signals aggregated at the reference's
     strength (zero knowledge, two levels of degree 2^14, build and prove
     seconds and stage ms a level), accepted by verify_aggregated on the
     card and rejected with a flipped nullifier; its first level proved
     again in two spawned workers on the card (procs=2, seeded child
     generators), equal array by array and in launches to proving each
     chunk in this process from the same children, accepted by the
     verifier on the card, a flipped child raising RuntimeError, the
     workers' start-up, rebuild and prove seconds beside the one-batch
     level's; aggregate_signals_np's
     digest equal to the same tree on the CPU with the plain permutation,
     its attestation rechecked, and rejected with a changed count;
 14. prints one JSON line per phase, the kernels' line, and as the last line
     {"ok": true, "device": {...}}.

`--only PHASE[,PHASE...]` runs the device and build phases and the named
ones, and ends with a line that says the run was partial, not the "ok"
line.

Any failure ends the run with a non-zero exit code and no "ok" line. There
is no fallback: without a card, without nvcc, or with a kernel that does
not build, launch or agree, the script fails.
"""
from __future__ import annotations

import concurrent.futures
import copy
import ctypes
import functools
import json
import multiprocessing
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from stark_verifier_tpu_torch.core import gates as G
from stark_verifier_tpu_torch.core import plonky2_io
from stark_verifier_tpu_torch.core import verifier as V
from stark_verifier_tpu_torch.core.challenger import Challenger
from stark_verifier_tpu_torch.core.merkle import MerkleTree, verify_merkle_proof_to_cap
from stark_verifier_tpu_torch.core.types import load_proofs
from stark_verifier_tpu_torch.models import flagship as FS
from stark_verifier_tpu_torch.ops import cuda_build, gl64, hashers, probes
from stark_verifier_tpu_torch.ops import field_kernel as FK
from stark_verifier_tpu_torch.ops import poseidon_bn254_kernel as bk
from stark_verifier_tpu_torch.ops import poseidon_gl as pg
from stark_verifier_tpu_torch.ops import ntt, ntt_np
from stark_verifier_tpu_torch.ops import ntt_kernel as NK
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk
from stark_verifier_tpu_torch.parallel import batch_verify as PB
from stark_verifier_tpu_torch.parallel.mesh import make_mesh
from stark_verifier_tpu_torch.parallel.multihost import init_distributed
from stark_verifier_tpu_torch.ops import witness_kernel as WK
from stark_verifier_tpu_torch.prover import prove as PV
from stark_verifier_tpu_torch.prover.builder import WitnessConflict
from stark_verifier_tpu_torch.prover.recursion import recursion_config
from stark_verifier_tpu_torch.semaphore import access_set as AS
from stark_verifier_tpu_torch.semaphore import aggregate as SAGG
from stark_verifier_tpu_torch.semaphore import attestation as SATT
from stark_verifier_tpu_torch.semaphore import recursion as SREC
from stark_verifier_tpu_torch.utils import sass
from stark_verifier_tpu_torch.utils.roofline import graph_ms

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "fixtures" / "sem_zk20b64.npz"
BATCH = 1024
WRAPPED = REPO / "fixtures" / "sem_wrapped16.npz"
WRAPPED_BATCH = 256
SEED = 20

# Published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of device
# memory; 67 TFLOP/s float32 outside the tensor cores = 33.5e12 fused
# multiply-adds a second on 128 lanes per SM. The 32-bit integer pipe has 64
# lanes per SM, so it issues half as many instructions: 16.75e12 a second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FMA_PER_S = 67e12 / 2
PEAK_INT32_INSTR_PER_S = 67e12 / 2 / 2
# dense tensor-core peaks of the same data sheet
PEAK_INT8_OPS_PER_S = 1979e12

# 32-bit integer instructions the permutation needs at the least, by count
# of the algorithm, one lane, at these unit costs:
#   field multiply: a 64x64->128 product is 4 wide 32x32 multiplies and 4
#     carry adds; the Goldilocks fold is 12 add/compare/select -> 20;
#   round-constant add on any representative: 9;
#   dense MDS layer: 2 * (144 + 1) wide multiply-adds of the words' 32-bit
#     halves by the matrix's entries (all below 2^6) + 12 recombine-and-fold
#     of about 10 -> 410;
#   s-boxes: 4 multiplies each, 12 lanes in 8 full rounds + 1 lane in 22
#     partial rounds -> 472 multiplies in every form below.
# Three forms of the same function:
#   dense (the TPU kernel's): 360 constant adds, 30 dense layers -> 24,980;
#   plonky2's fast form: the partial rounds' constants carried forward (12
#     adds before them, then one a round, the last 0) and their matrices
#     factored into an 11 x 11 full matrix applied once and 22 sparse ones,
#     whose entries are full 64-bit words: 121 + 22 * 11 products a 64x64
#     -> 128 product (8) into a 160-bit running sum (3) each, 11 + 22 folds
#     of that sum (12), 22 * 11 field multiplies v_i * s0 and adds (9), and
#     each round's s0 * 25 (5) -> 25,398 with the 8 dense full-round layers;
#   the constants carried forward as in plonky2's form, the matrices kept
#     dense (csrc/poseidon_gl.cu): 96 + 12 + 21 = 129 constant adds, 30
#     dense layers -> 22,901, the least of the three.
# The three Poseidon kernels compute one function, so they share the least
# count and one bound; the dense count is printed beside it.
INT32_INSTR_PER_PERMUTATION = 472 * 20 + 129 * 9 + 30 * 410
INT32_INSTR_PER_PERMUTATION_DENSE = 472 * 20 + 360 * 9 + 30 * 410
INT32_INSTR_PER_PERMUTATION_SPARSE = (
    472 * 20 + (96 + 12 + 21 + 22 * 11) * 9 + 8 * 410
    + (121 + 22 * 11) * (8 + 3) + (11 + 22) * 12 + 22 * 11 * 20 + 22 * 5)
BYTES_PER_PERMUTATION = 2 * 12 * 8

# The same count for the BN254 bridge permutation, one lane: the least that
# the function needs, in the sparse form csrc/poseidon_bn254.cu computes
# (the same function with fewer products; the dense form's count was
# 353,892), not what the kernel executes. Units:
#   w, a 64x64->128 word product accumulated into a running multiword sum:
#     4 wide 32x32 multiply-adds and 4 carry adds -> 8;
#   product of two Fr elements of four words, unreduced: 16 w -> 128;
#     a square: 10 w and 12 shifts to double the cross products -> 92;
#   Montgomery reduction of a sum of products: in each of 4 steps
#     m = t0 (-1/q) mod 2^64 (3 multiplies) and m q (4 w); then one
#     conditional subtraction of q (16), so that every operand of the next
#     product fits four words -> 156;
#   add, lazy (no subtraction): four 64-bit adds with carry -> 8.
# Per permutation:
#   MDS, 8 full rounds: 25 products each, each row's five summed in one
#     running sum and reduced once -> 200 products, 40 reductions;
#   MDS, 60 sparse partial rounds: lane 0 a row of 5 products, lanes 1..4
#     one product each, added to the lane -> 540 products, 60 + 240
#     reductions, 240 adds;
#   the last P, once: 4 rows of 4 products -> 16 products, 4 reductions;
#     so 756 products (dense: 1,700) and 344 reductions (dense: 340);
#   s-boxes x^5, 5 in each of 8 full rounds and 1 in each of 60 partial:
#     100 of 2 squares and 1 product, 300 reductions;
#   round constants, carried forward: 5 adds in each of 8 full rounds and 1
#     in each of 60 partial rounds -> 100 adds (dense: 340);
#   into Montgomery form: 4 products of a packed three-word value by R^2
#     (12 w) and 4 reductions; out of it: 4 reductions;
#   packing, from the code: for each of 4 elements 3 Goldilocks
#     canonicalisations (6) and 3 w for x2 p + x1, then times p plus x0
#     -> 168;
#   unpacking, from the code: for each of 4 elements 6 Goldilocks folds (12,
#     as in the Poseidon count above), 3 canonicalisations, 10 for the
#     subtractions over three and two words, and the two exact divisions'
#     products with 1/p: 4 word products with two adds (12) and 5 that keep
#     only the low word (a low product, 3, and two 64-bit adds, 4) -> 732.
BRIDGE_INT32_INSTR_PER_PERMUTATION = (
    756 * 128 + 100 * (2 * 92 + 128) + 4 * 12 * 8
    + (344 + 300 + 4 + 4) * 156 + (240 + 100) * 8 + 168 + 732)

# 32-bit integer instructions one mad_wide_u32 step of alu_probe needs at
# the least (phase_probes): y = lo32(y) * x + y is one IMAD.WIDE.U32 with the
# 64-bit y as its addend. Read from the one table of such counts,
# probes.MIN_PIPE_SLOTS, which tools/torch_vpu_microbench.py reads too.
MAD_WIDE_STEP_INSTRUCTIONS = probes.MIN_PIPE_SLOTS["mad_wide_u32"]

# The same count for one lane of poseidon_gate_fill (csrc/witness.cu), at the
# Poseidon count's unit costs (field multiply 20, constant add 9, dense MDS
# layer 410) and 3 a canonicalisation or a subtraction of canonical words:
#   8 full rounds: 12 constant adds, 12 s-boxes (48 multiplies), one layer;
#   the fast partial rounds: 12 constant adds before them, the 11 x 11
#     initial matrix (121 multiplies and adds), then 22 rounds of an s-box
#     (4 multiplies), a constant add, 11 w-hat and 11 v products with their
#     adds and s0 * 25;
#   the swap: 4 subtractions, multiplies, canonicalisations, an add and a
#     subtraction; 135 wires canonicalised as they are stored.
FILL_INT32_INSTR_PER_LANE = (
    8 * (12 * 9 + 48 * 20 + 410) + 12 * 9 + 121 * (20 + 9)
    + 22 * (4 * 20 + 9 + 22 * (20 + 9) + 20) + 4 * (3 + 20 + 3 + 9 + 3) + 135 * 3)
FILL_BYTES_PER_LANE = (12 + 1 + 135) * 8
# one Horner step of ext2_reduce_chain, one lane: 5 field multiplies (the
# schoolbook product's four and the twist's x 7), 4 adds, 2 canonicalisations
CHAIN_INT32_INSTR_PER_STEP = 5 * 20 + 4 * 9 + 2 * 3
# ext2_arith, one lane: the schoolbook product (4 multiplies, the twist's
# x 7 as one fold of 5, 2 adds), then c0 p + c1 z in each component (2
# multiplies, an add, a canonicalisation); 6 words read, 2 written
ARITH_INT32_INSTR_PER_LANE = 4 * 20 + 5 + 2 * 9 + 2 * (2 * 20 + 9 + 3)
ARITH_BYTES_PER_LANE = (6 + 2) * 8
# gl_inv, one lane: the addition chain's 64 squarings and 10 multiplies, a
# canonicalisation; one word read, one written
INV_INT32_INSTR_PER_LANE = 74 * 20 + 3
INV_BYTES_PER_LANE = 2 * 8
# ext2_inv, one lane: the inverse of the norm, 4 multiplies (a0^2, a1^2,
# a0 n, a1 n), the x 7 fold, the norm's subtraction of canonical words (9),
# two canonicalisations and a negation; two words read, two written
EXT2_INV_INT32_INSTR_PER_LANE = INV_INT32_INSTR_PER_LANE + 4 * 20 + 5 + 9 + 3 * 3
EXT2_INV_BYTES_PER_LANE = 4 * 8
# poseidon_gate_eval, one lane, at the Poseidon count's unit costs: 118
# s-boxes of 4 multiplies (round 0's 12 on the state, rounds 1..3's 36 and
# the second half's 48 on their wires, 22 partial), 8 dense MDS layers, the
# 11 x 11 initial matrix (121 multiplies and adds), 22 sparse rounds of 22
# multiplies and adds and s0 * 25 (5), 130 constant adds (96 in the full
# rounds, 12 forwarded, 22 partial), 123 constraints each a subtraction of
# two canonicalised words (9), the swap's 5 multiplies and the swapped
# inputs' 8 adds and subtractions. It reads the gate's 135 wires and
# writes 123 constraints a lane: (135 + 123) x 8 bytes.
EVAL_INT32_INSTR_PER_LANE = (
    118 * 4 * 20 + 8 * 410 + 121 * (20 + 9) + 22 * (22 * (20 + 9) + 5) + 130 * 9
    + 123 * 9 + 5 * 20 + 8 * 9)
EVAL_BYTES_PER_LANE = (135 + 123) * 8
# the field kernels, one element: the words read and written (three for
# mul, add and sub, four for mul_add, two for mul_small); operations counted
# from the built library's machine code (phase_field_kernels), else at the
# Poseidon count's unit costs: a field multiply 20, an add on any
# representative 9, a subtraction the same
FIELD_BYTES_PER_ELEMENT = {"gl_mul": 24, "gl_add": 24, "gl_sub": 24, "gl_mul_add": 32,
                           "gl_mul_small": 16}
FIELD_INT32_INSTR_PER_ELEMENT = {"gl_mul": 20, "gl_add": 9, "gl_sub": 9, "gl_mul_add": 29,
                                 "gl_mul_small": 20}

KERNEL_FILES = {
    "poseidon_permute": ("stark_verifier_tpu_torch/ops/csrc/poseidon_gl.cu",
                         "stark_verifier_tpu/ops/pallas/poseidon_kernel.py:331"),
    "poseidon_permute_mma": ("stark_verifier_tpu_torch/ops/csrc/poseidon_gl_mma.cu",
                             "stark_verifier_tpu/ops/pallas/poseidon_kernel.py:269"),
    "poseidon_permute_mma2": ("stark_verifier_tpu_torch/ops/csrc/poseidon_gl_mma.cu",
                              "stark_verifier_tpu/ops/pallas/poseidon_kernel.py:311"),
    "alu_probe": ("stark_verifier_tpu_torch/ops/csrc/probes.cu",
                  "tools/vpu_microbench.py:46"),
    "mma_probe": ("stark_verifier_tpu_torch/ops/csrc/probes.cu",
                  "tools/vpu_microbench.py:128"),
    # an addition: the JAX package computes the bridge with jnp ops, no
    # Pallas call; its counterpart is named here
    "bridge_permute12": ("stark_verifier_tpu_torch/ops/csrc/poseidon_bn254.cu",
                         "stark_verifier_tpu/ops/fr_bn254_jax.py:321"),
    # additions too: the JAX package's recursion prover computes these in
    # host C planes, no Pallas call; their counterparts are named here
    "poseidon_gate_fill": ("stark_verifier_tpu_torch/ops/csrc/witness.cu",
                           "native/svt_poseidon.c:434"),
    "ext2_reduce_chain": ("stark_verifier_tpu_torch/ops/csrc/witness.cu",
                          "native/svt_poseidon.c:474"),
    # the rest of the host C plane on the provers' path, and the numpy
    # field's inverse (the Fermat power on the svt_gl_mul plane), with its
    # extension form
    "ext2_arith": ("stark_verifier_tpu_torch/ops/csrc/witness.cu",
                   "native/svt_poseidon.c:457"),
    "gl_inv": ("stark_verifier_tpu_torch/ops/csrc/witness.cu",
               "stark_verifier_tpu/ops/gl64_np.py:189"),
    "ext2_inv": ("stark_verifier_tpu_torch/ops/csrc/witness.cu",
                 "stark_verifier_tpu/ops/ext2.py:87"),
    "poseidon_gate_eval": ("stark_verifier_tpu_torch/ops/csrc/witness.cu",
                           "native/svt_poseidon.c:680"),
    # the elementwise field plane: the JAX package's host C plane for four of
    # them, its numpy field's small-constant multiply for the fifth
    "gl_mul": ("stark_verifier_tpu_torch/ops/csrc/field.cu", "native/svt_poseidon.c:277"),
    "gl_add": ("stark_verifier_tpu_torch/ops/csrc/field.cu", "native/svt_poseidon.c:295"),
    "gl_sub": ("stark_verifier_tpu_torch/ops/csrc/field.cu", "native/svt_poseidon.c:321"),
    "gl_mul_add": ("stark_verifier_tpu_torch/ops/csrc/field.cu", "native/svt_poseidon.c:339"),
    "gl_mul_small": ("stark_verifier_tpu_torch/ops/csrc/field.cu",
                     "stark_verifier_tpu/ops/gl64_np.py:154"),
    # the NTT plane: the JAX package's host C NTT and coset LDE (its prover's
    # default LDE backend; its XLA transform, ops/ntt_jax.py, has no Pallas
    # call). The two kernels together replace both functions: ntt_tile
    # svt_coset_lde_batch's scaling and zero padding with the bit-reversed
    # load and the low stages of svt_ntt_batch, ntt_stride its upper stages
    "ntt_tile": ("stark_verifier_tpu_torch/ops/csrc/ntt.cu", "native/svt_poseidon.c:813"),
    "ntt_stride": ("stark_verifier_tpu_torch/ops/csrc/ntt.cu", "native/svt_poseidon.c:754"),
}
ADDITIONS = {"bridge_permute12", "poseidon_gate_fill", "ext2_reduce_chain", "ext2_arith",
             "gl_inv", "ext2_inv", "poseidon_gate_eval", *FK.KERNELS, *NK.KERNELS}
PERMUTES = {m: functools.partial(pg.permute, mxu=m) for m in (0, 1, 2)}

EDGES = np.array(
    [0, 1, gl64.P - 1, gl64.P, gl64.P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1],
    dtype=np.uint64)


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps):
    """Mean device time of `fn` over `reps` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def edge_state(rng, lanes):
    """uint64[12, lanes]: full-range random words (non-canonical ones
    included), a quarter of them replaced by edge values, and, where there
    is room, every edge value once in every state position."""
    s = rng.integers(0, 2**64, size=(12, lanes), dtype=np.uint64)
    pick = rng.random((12, lanes)) < 0.25
    s[pick] = rng.choice(EDGES, size=int(pick.sum()))
    if lanes >= 12 * len(EDGES):
        for pos in range(12):
            for k, e in enumerate(EDGES):
                s[pos, pos * len(EDGES) + k] = e
    return s


# ------------------------------------------------------------------ phases
def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, smi_line


# device time of one launch of an empty kernel (phase_build)
LAUNCH_FLOOR: dict = {}


def phase_build(device):
    t0 = time.time()
    logs = cuda_build.build_all()
    for kernel in pk.KERNELS:          # load, bind, upload the round constants
        pk._library(pk._HOME[kernel], device)
    probes._library()
    bk._library(device)
    WK._library(device)
    FK._library(device)
    NK._library(device)
    seconds = time.time() - t0
    LAUNCH_FLOOR["ms"] = graph_ms(lambda: WK.empty_launch(device), 50)
    emit({"phase": "build", "sources": sorted(cuda_build.SOURCES.values()),
          "nvcc": cuda_build.nvcc_path(), "flags": cuda_build.NVCC_FLAGS,
          "source_flags": cuda_build.SOURCE_FLAGS,
          "seconds": round(seconds, 2), "built": sorted(n for n, log in logs.items() if log),
          "launch_floor_ms": LAUNCH_FLOOR["ms"]})
    # one line per kernel: registers and spills of each of its entry points
    # (the Poseidon kernels' narrow grids are kernels of their own), as
    # ptxas reported them when the library was built
    for name, (source, _) in KERNEL_FILES.items():
        report = cuda_build.ptxas_report(Path(source).stem)
        functions = report.get(f"{name}_kernel", []) + report.get(f"{name}_narrow_kernel", [])
        check(bool(functions) and all("registers" in f and "spill_stores" in f
                                      for f in functions),
              f"no ptxas report for {name}")
        if name in WK.KERNELS + FK.KERNELS + NK.KERNELS:
            check(all(f["spill_stores"] == 0 and f["spill_loads"] == 0 for f in functions),
                  f"{name} spills: {functions}")
        emit({"phase": "ptxas", "kernel": name, "source": source,
              "max_registers": max(f["registers"] for f in functions),
              "spill_stores": max(f["spill_stores"] for f in functions),
              "spill_loads": max(f["spill_loads"] for f in functions),
              "functions": functions})


def least_time(t_bytes, t_ops):
    """The least time of a launch: the larger of its bound (bytes or
    operations over the card's rates) and the launch floor, and which one
    it is."""
    bound = max(t_bytes, t_ops)
    floor = LAUNCH_FLOOR["ms"]
    by = "launch" if floor > bound else ("bytes" if t_bytes >= t_ops else "operations")
    return {"bound_ms": bound, "launch_floor_ms": floor, "least_ms": max(bound, floor),
            "least_by": by}


def kernel_row(name, ms, plain_ms, t_bytes, t_ops, library_ms=None,
               max_abs_err=0.0, **extra):
    source, replaces = KERNEL_FILES[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "addition": name in ADDITIONS,
            "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bound_bytes_ms": t_bytes,
            "bound_operations_ms": t_ops, **least_time(t_bytes, t_ops), **extra}


# ------------------------------------------------------------ field kernels
# element counts at which phase_field_kernels holds the five field kernels
# against their plain versions: none, one, a ragged count, the counts the
# verifier paths launch them at most (a zk20 batch of 1,024 makes 8,471 of
# its 12,385 field launches at 1,024 elements, 3,080 at 28 x 1,024 and 313
# at 12 x 1,024; a wrapped batch the same at 256 lanes), and the card's width
FIELD_SIZES = [0, 1, 7, 1025, WRAPPED_BATCH, BATCH, 12 * BATCH, 28 * BATCH, 1 << 24]
FIELD_TIMED_SIZES = [WRAPPED_BATCH, BATCH, 28 * BATCH, 1 << 24]
FIELD_KS = [0, 1, 2, 7, 25, 2**15 - 1]      # mul_small's constants (0, 1: no launch)
FIELD_PLAIN = {"gl_mul": gl64.mul_plain, "gl_add": gl64.add_plain, "gl_sub": gl64.sub_plain,
               "gl_mul_add": gl64.mul_add_plain}
FIELD_WRAPPERS = {"gl_mul": FK.mul, "gl_add": FK.add, "gl_sub": FK.sub,
                  "gl_mul_add": FK.mul_add}
# the field kernels' launches by the path that made them (main_path,
# wrapped, prove, recursion), for the kernels' rows
FIELD_PATH_LAUNCHES: dict = {}


def field_words(rng, shape):
    """uint64 words of `shape`: full-range ones, a quarter of them edge
    words; where there is room, every triple of edge words first."""
    w = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    pick = rng.random(shape) < 0.25
    w[pick] = rng.choice(EDGES, size=int(pick.sum()))
    return w


def field_operands(rng, n, device):
    """{form: (a, b, c)} on the card, each form's output n elements (n x 2
    for "broadcast"): "equal" ([n] each; every triple of edge words among
    them where n allows), "broadcast" ([2, n] against [n] and [2, 1], the
    NTT's twiddles), "0-dim" ([n] against two 0-dim words, `F.const`),
    "strided" (views with strides 2 and 3, the prover's halving fold)."""
    m = len(EDGES)
    eq = field_words(rng, (3, n))
    if n >= m ** 3:
        eq[:, :m ** 3] = np.stack(np.meshgrid(EDGES, EDGES, EDGES, indexing="ij")).reshape(3, -1)
    up = functools.partial(gl64.from_u64, device=device)
    two, three = up(field_words(rng, (n, 2))), up(field_words(rng, (n, 3)))
    return {"equal": tuple(up(w) for w in eq),
            "broadcast": (up(field_words(rng, (2, n))), up(eq[1]), up(field_words(rng, (2, 1)))),
            "0-dim": (up(eq[0]), up(field_words(rng, ())), up(field_words(rng, ()))),
            "strided": (two[:, 0], two[:, 1], three[:, 2])}


def field_sass_ops():
    """{kernel: machine instructions an element, loads, stores and the
    loop's control left out} of each field kernel's one-dim form, from the
    built library (`cuobjdump`), or None without it."""
    listing = sass.listings(cuda_build._target("field"))
    if listing is None:
        return None
    found = {}
    for name in FK.KERNELS:
        ident = f"{name}_kernel"
        fns = [k for k in listing if k.startswith(f"_Z{len(ident)}{ident}ILb1E")]
        check(len(fns) == 1, f"{name}: one-dim kernels in the library: {fns}")
        body = max(sass.loops(listing[fns[0]]), key=len, default=None)
        check(body is not None, f"{name}: no loop in the one-dim kernel's machine code")
        ops = sass.step_counts(body, 1)["by_opcode"]
        found[name] = {"instructions": sum(c for op, c in ops.items()
                                           if not op.startswith(("LD", "ST", "ULD"))),
                       "by_opcode": ops}
    return found


def phase_field_kernels(device, rows):
    """The five field kernels of csrc/field.cu word for word against their
    plain versions, on the card and on the CPU, in every operand form the
    paths give, edge words in every operand, at FIELD_SIZES; then timed
    (device time from a CUDA graph) at FIELD_TIMED_SIZES beside their bounds
    and the launch floor, and the wrapper's host time a call."""
    rng = np.random.default_rng(SEED + 20)
    checked = 0
    by_kernel = {name: {} for name in FK.KERNELS}
    for n in FIELD_SIZES:
        forms = field_operands(rng, n, device)
        for form, (a, b, c) in forms.items():
            on_cpu = n < (1 << 24) or form == "equal"
            cpu = [t.cpu() for t in (a, b, c)] if on_cpu else None
            for name in FK.KERNELS:
                if name == "gl_mul_small":
                    cases = [(f"k={k}", lambda k=k: FK.mul_small(a, k),
                              lambda k=k: gl64.mul_small_plain(a, k),
                              lambda k=k: gl64.mul_small_plain(cpu[0], k), k > 1)
                             for k in FIELD_KS]
                else:
                    arity = 3 if name == "gl_mul_add" else 2
                    cases = [("", lambda: FIELD_WRAPPERS[name](*(a, b, c)[:arity]),
                              lambda: FIELD_PLAIN[name](*(a, b, c)[:arity]),
                              lambda: FIELD_PLAIN[name](*cpu[:arity]), True)]
                    if name == "gl_sub":
                        cases.append(("neg", lambda: FK.neg(c),
                                      lambda: gl64.sub_plain(torch.zeros_like(c), c),
                                      lambda: gl64.sub_plain(torch.zeros_like(cpu[2]), cpu[2]),
                                      True))
                for label, kernel, plain, plain_cpu, launches in cases:
                    before = FK.LAUNCHES[name]
                    got = kernel()
                    where = f"{name} {label} ({form}, {n} elements)"
                    check(FK.LAUNCHES[name] - before == int(launches and got.numel() > 0),
                          f"{where}: launched {FK.LAUNCHES[name] - before} times")
                    want = plain()
                    check(got.shape == want.shape and torch.equal(got, want),
                          f"{where} differs from its plain version on the card")
                    if on_cpu:
                        check(torch.equal(got.cpu(), plain_cpu()),
                              f"{where} differs from its plain version on the CPU")
                    checked += 1
        del forms
        torch.cuda.empty_cache()
    # ---- 8 dims that no merge joins (a transposed view against size-1
    # dims): `fit` copies what keeps them apart, one launch a call
    z = gl64.from_u64(field_words(rng, (3, 4, 3, 4, 3, 4, 3, 8)), device)[..., ::2]
    z = z.permute(7, 6, 5, 4, 3, 2, 1, 0)
    w = gl64.from_u64(field_words(rng, (4, 1, 4, 1, 4, 1, 4, 1)), device)
    k = gl64.from_u64(field_words(rng, ()), device)
    ops = {"gl_mul": (z, w), "gl_add": (w, z), "gl_sub": (z, w), "gl_mul_add": (z, w, k)}
    for name in FK.KERNELS:
        args = (z,) if name == "gl_mul_small" else ops[name]
        check(FK._geometry(args)[1] is None, f"{name}: rank-8 operands merged")
        kernel = (lambda: FK.mul_small(z, 7)) if name == "gl_mul_small" else (
            lambda: FIELD_WRAPPERS[name](*args))
        plain = (lambda a: gl64.mul_small_plain(a[0], 7)) if name == "gl_mul_small" else (
            lambda a: FIELD_PLAIN[name](*a))
        before = FK.LAUNCHES[name]
        got = kernel()
        check(FK.LAUNCHES[name] - before == 1, f"{name} rank 8: {FK.LAUNCHES[name] - before} "
              f"launches")
        check(got.shape == z.shape and torch.equal(got, plain(args)),
              f"{name} rank 8 differs from its plain version on the card")
        check(torch.equal(got.cpu(), plain([t.cpu() for t in args])),
              f"{name} rank 8 differs from its plain version on the CPU")
        checked += 1
    del z, w, k

    # ---- timed, the equal form: device time from a CUDA graph of 50
    # launches, beside the bounds; the plain version's one call
    sass_ops = field_sass_ops()
    for n in FIELD_TIMED_SIZES:
        a, b, c = (gl64.from_u64(field_words(rng, (n,)), device) for _ in range(3))
        calls = {"gl_mul": (lambda: FK.mul(a, b), lambda: gl64.mul_plain(a, b)),
                 "gl_add": (lambda: FK.add(a, b), lambda: gl64.add_plain(a, b)),
                 "gl_sub": (lambda: FK.sub(a, b), lambda: gl64.sub_plain(a, b)),
                 "gl_mul_add": (lambda: FK.mul_add(a, b, c),
                                lambda: gl64.mul_add_plain(a, b, c)),
                 "gl_mul_small": (lambda: FK.mul_small(a, 7),
                                  lambda: gl64.mul_small_plain(a, 7))}
        for name, (kernel, plain) in calls.items():
            instr = (FIELD_INT32_INSTR_PER_ELEMENT[name] if sass_ops is None
                     else sass_ops[name]["instructions"])
            t_bytes = n * FIELD_BYTES_PER_ELEMENT[name] / PEAK_BYTES_PER_S * 1e3
            t_ops = n * instr / PEAK_INT32_INSTR_PER_S * 1e3
            _, plain_ms = timed_plain(plain)
            by_kernel[name][n] = {"ms": graph_ms(kernel, 50), "plain_ms": plain_ms,
                                  "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
                                  **least_time(t_bytes, t_ops)}
        del a, b, c

    # ---- the wrapper's host time a call, at the zk20 path's most frequent
    # count (1,024 elements): calls issued back to back, no synchronise
    # between them, beside the plain version's (40 PyTorch ops for mul)
    a, b = (gl64.from_u64(field_words(rng, (BATCH,)), device) for _ in range(2))
    host_us = {}
    for label, fn in (("gl_mul", lambda: FK.mul(a, b)), ("gl_add", lambda: FK.add(a, b)),
                      ("gl_mul, 0-dim operand", lambda: FK.mul(a, b[0])),
                      ("of which launch_args", lambda: FK.launch_args(a, b)),
                      ("of which torch.empty", lambda: torch.empty_like(a)),
                      ("gl_mul_plain", lambda: gl64.mul_plain(a, b))):
        reps = 2000 if "plain" not in label else 200
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_us[label] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()

    widest = FIELD_TIMED_SIZES[-1]
    for name in FK.KERNELS:
        top = by_kernel[name][widest]
        rows[name] = kernel_row(
            name, top["ms"], top["plain_ms"], top["bound_bytes_ms"],
            top["bound_operations_ms"], elements=widest, by_elements=by_kernel[name],
            instructions_an_element="not measured: no cuobjdump" if sass_ops is None
            else sass_ops[name]["instructions"],
            sass_an_element=None if sass_ops is None else sass_ops[name]["by_opcode"],
            hand_count_an_element=FIELD_INT32_INSTR_PER_ELEMENT[name])
    emit({"phase": "field_kernels", "sizes": FIELD_SIZES,
          "forms": ["equal", "broadcast", "0-dim", "strided", "neg (null operand)",
                    "rank 8 (one launch through fit)"],
          "checks": checked, "equal_to_plain_on_card_and_cpu": True,
          "host_us_a_call": host_us,
          **{name: rows[name] for name in FK.KERNELS}})


# Lane counts at which a verifier path launches the Poseidon kernel: one
# proof's transcript, leaf hashes and merged walk (1, 28, 112), the wrapped
# path's public-input hash (256), and a zk20 batch of 1024: its transcript
# (1024), leaf hashes and fold-layer walks (28 x 1024), merged 4-oracle walk
# (4 x 28 x 1024).
PATH_LANES = [1, 28, 112, WRAPPED_BATCH, BATCH, 28 * BATCH, 4 * 28 * BATCH]
# launches by lane count in one zk20 batch of 1024 (phase_main_path checks it)
ZK20_LAUNCHES_BY_LANES = {BATCH: 136, 28 * BATCH: 57, 4 * 28 * BATCH: 8}
# the inverse kernel's launches in one batch of the batched verifier: every
# ext2.div is one ext2_inv (one at [B], the others at [B, 28]); no gl_inv
ZK20_INVERSE_LAUNCHES = {"ext2_inv": 7}
WRAPPED_INVERSE_LAUNCHES = {"ext2_inv": 11}
# the field kernels' launches in one batch of the batched verifier: every
# gl64.mul, add, sub (8 / 16 of them gl64.neg) and mul_small outside the
# Poseidon, bridge and inverse kernels; the verifier's extension ring has no
# mul_add. tests/test_torch_field_kernel.py counts the zk20 path's calls on
# the CPU against these.
ZK20_FIELD_LAUNCHES = {"gl_mul": 3495, "gl_add": 6381, "gl_sub": 1337, "gl_mul_add": 0,
                       "gl_mul_small": 1172}
WRAPPED_FIELD_LAUNCHES = {"gl_mul": 3821, "gl_add": 6957, "gl_sub": 1562, "gl_mul_add": 0,
                          "gl_mul_small": 1284}
# ... and in the prove phase's counted prove_batch of 64 signals (the
# quotient's gates over the base ring call mul_add; the NTTs launch their
# own kernels, ntt_launches(PROVE_NTT_BITS)). tests/test_torch_ntt_kernel.py
# counts the same prove's calls on the CPU against these.
PROVE_FIELD_LAUNCHES = {"gl_mul": 794, "gl_add": 728, "gl_sub": 149, "gl_mul_add": 170,
                        "gl_mul_small": 190}
# a compiled batch's graph holds at most this many nodes (its launches)
GRAPH_NODES_AT_MOST = {"zk20": 30_000, "wrapped": 35_000}
# witness.cu's launches by the path that made them (main_path, prove), for
# the kernels' rows that phase_recursion writes
PATH_LAUNCHES: dict = {}


def poseidon_bound_ms(lanes):
    """(bytes, operations) bounds of `lanes` permutations, in ms."""
    return (lanes * BYTES_PER_PERMUTATION / PEAK_BYTES_PER_S * 1e3,
            lanes * INT32_INSTR_PER_PERMUTATION / PEAK_INT32_INSTR_PER_S * 1e3)


def phase_poseidon_kernels(device, rows):
    """The three Poseidon kernels against their plain versions and against
    each other on the card, then timed in turns at every lane count a
    verifier path launches them at."""
    rng = np.random.default_rng(SEED)
    # both sides of each kernel's threshold between its two grids
    thresholds = (pk.SPLIT_MAX_LANES, pk.MMA_MAX_LANES, pk.MMA2_MAX_LANES)
    lane_counts = sorted(set(PATH_LANES) | {7, 8, 1025}
                         | {n + d for n in thresholds for d in (0, 1)})
    inputs = {}
    for lanes in lane_counts:
        x = inputs[lanes] = gl64.from_u64(edge_state(rng, lanes), device)
        first = None
        for mxu, name in enumerate(pk.KERNELS):
            got = pk.permute(x, mxu)
            torch.cuda.synchronize()
            want = pk.permute_plain(x, mxu)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                a = got.cpu().numpy().view(np.uint64).astype(object)
                b = want.cpu().numpy().view(np.uint64).astype(object)
                fail(f"{name} != permute_plain(mxu={mxu}) at {lanes} lanes "
                     f"(max abs difference {int(np.abs(a - b).max())})")
            first = got if first is None else first
            check(torch.equal(got, first),
                  f"{name} != poseidon_permute at {lanes} lanes")
            # a trailing shape other than flat must give the same words
            if lanes == 28 * BATCH:
                got2 = pk.permute(x.reshape(12, BATCH, 28), mxu)
                check(torch.equal(got2.reshape(12, -1), want),
                      f"{name} differs on a [12, B, Q] state")
    # timed on the states they were compared on, in turns at each count,
    # each as 50 launches of the wrapper in a CUDA graph
    timed = {name: {} for name in pk.KERNELS}
    for lanes in PATH_LANES:
        x = inputs[lanes]
        for mxu in (0, 1, 2, 2, 1, 0):  # in turns: a drifting clock favours none
            t = graph_ms(lambda: pk.permute(x, mxu), 50)
            by = timed[pk.KERNELS[mxu]]
            by[lanes] = min(t, by.get(lanes, t))
    by_lanes = {}
    for lanes in PATH_LANES:
        t_bytes, t_ops = poseidon_bound_ms(lanes)
        bound = max(t_bytes, t_ops)
        by_lanes[lanes] = {
            "bound_ms": bound, "grid_threads_per_permutation": {
                name: pk.threads_per_permutation(lanes, mxu)
                for mxu, name in enumerate(pk.KERNELS)}, **{
            name: {"ms": timed[name][lanes], "share_of_bound": bound / timed[name][lanes]}
            for name in pk.KERNELS}}
    lanes = PATH_LANES[-1]
    x = inputs[lanes]
    t_bytes, t_ops = poseidon_bound_ms(lanes)
    for mxu, name in enumerate(pk.KERNELS):
        pk.permute_plain(x, mxu)
        plain_ms = cuda_ms(lambda: pk.permute_plain(x, mxu), 3)
        ms = timed[name][lanes]
        # library_ms None: no PyTorch call computes this function
        rows[name] = kernel_row(
            name, ms, plain_ms, t_bytes, t_ops, lanes=lanes,
            ms_by_lanes=timed[name],
            permutations_per_s=lanes / (ms * 1e-3))
    # the rule for the default kernel: a variant takes it only if it is
    # more than 5 % faster than poseidon_permute at both wide counts and no
    # slower at the transcript's 1,024 lanes, in this run
    base = timed[pk.KERNELS[0]]
    default_rule = {name: {
        "faster_by_at_wide": {n: 1 - timed[name][n] / base[n] for n in PATH_LANES[-2:]},
        "ratio_at_1024": timed[name][BATCH] / base[BATCH],
        "qualifies": all(timed[name][n] < 0.95 * base[n] for n in PATH_LANES[-2:])
        and timed[name][BATCH] <= base[BATCH]} for name in pk.KERNELS[1:]}
    emit({"phase": "poseidon_kernels", "lane_counts": lane_counts,
          "equal_to_plain_and_to_each_other": True,
          "default_rule": default_rule,
          "instructions_per_permutation": INT32_INSTR_PER_PERMUTATION,
          "instructions_per_permutation_dense": INT32_INSTR_PER_PERMUTATION_DENSE,
          "instructions_per_permutation_sparse": INT32_INSTR_PER_PERMUTATION_SPARSE,
          "split_max_lanes": pk.SPLIT_MAX_LANES, "mma_max_lanes": pk.MMA_MAX_LANES,
          "mma2_max_lanes": pk.MMA2_MAX_LANES,
          "by_lanes": by_lanes,
          **{name: rows[name] for name in pk.KERNELS}})


def timed_plain(fn):
    """One call of a plain version: its result and its device time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_probes(device, rows):
    """alu_probe (every op, one chain and four) and mma_probe (both kinds) at
    the size that fills the card, which is the size the rate tool
    (tools/torch_vpu_microbench.py) gives them: first held against their
    plain versions on those tensors, then, with the probes' launch counts
    set to 0, timed as the tool times them. The counts read after that are
    the rows' `launches`: the probes are on no verifier path (the main path
    and the per-proof path check that they launch none), their path is the
    tool's timed loop."""
    rng = np.random.default_rng(SEED + 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, chain, reps, warm = sms * 2048 * 4, 512, 20, 3
    row_op = "mad_wide_u32"   # the instruction the Poseidon kernels execute most
    inputs = {op: probes.alu_input(op, n, rng, device) for op in probes.OPS}
    M = torch.from_numpy(rng.integers(0, 64, (12, 12), dtype=np.uint8)).to(device)
    cols, steps = sms * 4 * probes.MMA_BLOCK_COLS, 30
    y = torch.from_numpy(rng.integers(0, 256, (12, cols), dtype=np.uint8)).to(device)

    # ---- against the plain versions, on the tensors that are timed below
    worst_fma, alu_plain_ms = 0.0, {}
    for op, big in inputs.items():
        for ilp in (1, 4):
            got = probes.alu_probe(big, op, chain, ilp)
            want, alu_plain_ms[op, ilp] = timed_plain(
                lambda: probes.alu_plain(big, op, chain, ilp))
            if op == "fma_f32":
                # the kernel's fused multiply-add rounds once a step, the
                # plain y * x + x twice; x < 1 makes the map a contraction,
                # so the difference does not grow along the chain
                check(bool(torch.isfinite(got).all())
                      and torch.allclose(got, want, rtol=1e-5, atol=0),
                      f"alu_probe fma_f32 ilp={ilp}: beyond rtol 1e-5")
                worst_fma = max(worst_fma, float((got - want).abs().max()))
            else:
                check(torch.equal(got, want),
                      f"alu_probe {op} ilp={ilp} differs at {n} elements")
    want, mma_plain_ms = timed_plain(lambda: probes.mma_plain(y, M, steps))
    for kind in probes.KINDS:
        check(torch.equal(probes.mma_probe(y, M, kind, steps), want),
              f"mma_probe {kind} differs from its plain version at {cols} columns")

    # ---- what a step of each chain loop executes, from the built library
    listing = sass.listings(cuda_build._target("probes"))
    steps_sass = None if listing is None else probes.step_sass(listing)
    if steps_sass is not None:
        for op, by_ilp in probes.STEP_SASS.items():
            for ilp, design in by_ilp.items():
                got = steps_sass[op, ilp]["by_opcode"]
                check(got == design, f"alu_probe {op} ilp={ilp}: a step of the "
                      f"chain loop executes {got}, designed {design}")

    # ---- the probes' own path: the timed loop, counted
    reset_counts()
    per_op = {}
    for op, big in inputs.items():
        slots = probes.MIN_PIPE_SLOTS[op]
        peak = PEAK_F32_FMA_PER_S if op == "fma_f32" else PEAK_INT32_INSTR_PER_S
        for ilp in (1, 4):
            for _ in range(warm):
                probes.alu_probe(big, op, chain, ilp)
            ms = cuda_ms(lambda: probes.alu_probe(big, op, chain, ilp), reps)
            bound = None if slots is None else n * chain * ilp * slots / peak * 1e3
            per_op[f"{op}, ilp={ilp}"] = {
                "ms": ms, "steps_per_s": n * chain * ilp / (ms * 1e-3),
                "plain_ms": alu_plain_ms[op, ilp], "min_pipe_slots_a_step": slots,
                "bound_ms": bound,
                "share_of_bound": None if bound is None else bound / ms,
                "machine_instructions_a_step":
                    "not measured: no cuobjdump" if steps_sass is None
                    else steps_sass[op, ilp]["instructions_a_step"]}
    mma_ms = {}
    for kind in probes.KINDS:
        for _ in range(warm):
            probes.mma_probe(y, M, kind, steps)
        mma_ms[kind] = cuda_ms(lambda: probes.mma_probe(y, M, kind, steps), reps)
    torch.cuda.synchronize()
    counts = dict(probes.LAUNCHES)
    check(counts["alu_probe"] == len(probes.OPS) * 2 * (warm + reps)
          and counts["mma_probe"] == len(probes.KINDS) * (warm + reps),
          f"the probes' timed loop counted {counts}")
    check(all(c == 0 for c in pk.LAUNCHES.values())
          and not any(bk.LAUNCHES.values()),
          "the probes' path launched a Poseidon kernel")

    # the least a step needs, one IMAD.WIDE.U32, at the 32-bit integer rate
    # like every instruction of the bounds here; the built loop body is that
    # one instruction a step (checked above where cuobjdump is there)
    ops = n * chain * 4 * MAD_WIDE_STEP_INSTRUCTIONS
    rows["alu_probe"] = kernel_row(
        "alu_probe", per_op[f"{row_op}, ilp=4"]["ms"], alu_plain_ms[row_op, 4],
        n * (4 + 8) / PEAK_BYTES_PER_S * 1e3, ops / PEAK_INT32_INSTR_PER_S * 1e3,
        max_abs_err=worst_fma, op=row_op, ilp=4, chain=chain, elements=n,
        instructions_per_step=MAD_WIDE_STEP_INSTRUCTIONS,
        machine_instructions_a_step=per_op[f"{row_op}, ilp=4"]["machine_instructions_a_step"],
        sass_a_step="not measured: no cuobjdump" if steps_sass is None
        else steps_sass[row_op, 4]["by_opcode"],
        tolerance="fma_f32 rtol 1e-5, every other op exact")
    # the one PyTorch call that computes the products: torch.matmul, chained
    # (scaled so that float32 stays finite without the mod 256)
    Mf, yf = M.to(torch.float32) / 512, y.to(torch.float32)

    def library():
        v = yf
        for _ in range(steps):
            v = torch.matmul(Mf, v)
        return v

    library()
    library_ms = cuda_ms(library, 3)
    # the product's own work, 12 x 12 a column: the zero padding of the
    # 16 x 16 tile is not counted
    rows["mma_probe"] = kernel_row(
        "mma_probe", mma_ms["u8"], mma_plain_ms,
        2 * 12 * cols / PEAK_BYTES_PER_S * 1e3,
        2 * 12 * 12 * cols * steps / PEAK_INT8_OPS_PER_S * 1e3,
        library_ms=library_ms, kind="u8", columns=cols, steps=steps,
        ms_tf32=mma_ms["tf32"])
    for name in probes.LAUNCHES:
        rows[name]["launches"] = counts[name]
    emit({"phase": "probes", "compared_at": {"elements": n, "columns": cols},
          "launches_in_timed_loop": counts, "alu_ops": per_op,
          "alu_probe": rows["alu_probe"], "mma_probe": rows["mma_probe"]})


def challenges_u64(F, common, digest, pa, perm, inner=None):
    """Public-input hash and every Fiat-Shamir challenge as uint64 numpy.
    `perm` is the transcript's permutation and `inner` the public-input
    hash's; without `inner`, `perm` hashes the public inputs too."""
    batch = tuple(pa["public_inputs"].shape[:-1])
    pi_hash, ch = V.phase_challenges(F, common, digest, pa, permute=perm,
                                     batch=batch, inner_permute=inner or perm)
    flat = list(pi_hash)
    for name in ("plonk_betas", "plonk_gammas", "plonk_alphas",
                 "fri_query_indices"):
        flat += ch[name]
    flat += [*ch["plonk_zeta"], *ch["fri_alpha"], ch["fri_pow_response"]]
    for b in ch["fri_betas"]:
        flat += [*b]
    return np.stack([gl64.to_u64(t) for t in flat])


def corrupt(batched, lanes):
    """One bit flipped in five different places, one place per lane."""
    bad = {k: v.copy() for k, v in batched.items()}
    one = np.uint64(1)
    bad["open_wires"][lanes[0], 0, 0] ^= one
    bad["init_sibs_1"][lanes[1], 5, 2, 1] ^= one
    bad["step_evals_0"][lanes[2], 7, 1, 0] ^= one
    bad["pow_witness"][lanes[3]] ^= one
    bad["final_poly"][lanes[4], 3, 1] ^= one
    return bad


def reset_counts():
    for counts in (pk.LAUNCHES, probes.LAUNCHES, bk.LAUNCHES, WK.LAUNCHES, FK.LAUNCHES,
                   NK.LAUNCHES):
        for name in counts:
            counts[name] = 0


def load_fixture():
    proofs, common, vk = load_proofs(FIXTURE)
    cfg = common.config.fri_config
    check(common.config.num_wires == 135 and cfg.num_query_rounds == 28
          and common.degree_bits == 9 and common.fri_params.hiding,
          "the fixture is not the zk20 circuit")
    return proofs, common, vk


def phase_main_path(device, rows):
    proofs, common, vk = load_fixture()
    distinct = len(proofs)
    cfg = common.config.fri_config
    while len(proofs) < BATCH:
        proofs = proofs + proofs
    proofs = proofs[:BATCH]
    batched = FS.batched_arrays(proofs)
    F = gl64.Field(device)
    digest = F.from_u64(vk.circuit_digest)

    fn, to_device = FS.make_verifier_fn_batched(common, vk)  # device="cuda"
    pa = to_device(batched)
    small = {k: v[:64] for k, v in batched.items()}
    pa64 = to_device(small)
    lanes = [3, BATCH // 10, BATCH // 2, BATCH * 7 // 10, BATCH - 24]
    pa_bad = to_device(corrupt(batched, lanes))
    expect = torch.ones(BATCH, dtype=torch.bool)
    expect[lanes] = False
    torch.cuda.synchronize()

    # ---- the path's permutation calls, counted apart from the wrappers'
    # counts: a counting permutation handed to the same path at B = 64
    calls = [0]

    def counting(F_, state):
        calls[0] += 1
        return pg.permute(F_, state)

    fn_count, _ = FS.make_verifier_fn_batched(common, vk, permute=counting,
                                              inner_permute=counting)
    ok64 = fn_count(pa64)
    n_calls = calls[0]

    # ---- the main path once per kernel variant, counted: every call
    # recorded by its lane count as well
    default = pk._use_mxu()
    launches, ms_once, ch_by, by_lanes = {}, {}, {}, {}
    for mxu, name in enumerate(pk.KERNELS):
        lane_counts = []

        def recording(F_, state, mxu=mxu, lane_counts=lane_counts):
            lane_counts.append(state.numel() // 12)
            return pg.permute(F_, state, mxu)

        fn_m = FS.make_verifier_fn_batched(common, vk, permute=recording,
                                           inner_permute=recording)[0]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        ok = fn_m(pa)
        torch.cuda.synchronize()
        ms_once[name] = (time.perf_counter() - t0) * 1e3
        counts = dict(pk.LAUNCHES)
        inverses = {k: c for k, c in WK.LAUNCHES.items() if c}
        check(inverses == ZK20_INVERSE_LAUNCHES,
              f"mxu={mxu}: witness.cu launches {inverses} in a batch, expected "
              f"{ZK20_INVERSE_LAUNCHES}")
        PATH_LAUNCHES["zk20_batch"] = inverses
        check(FK.LAUNCHES == ZK20_FIELD_LAUNCHES,
              f"mxu={mxu}: field launches {FK.LAUNCHES} in a batch, expected "
              f"{ZK20_FIELD_LAUNCHES}")
        FIELD_PATH_LAUNCHES["zk20_batch"] = dict(FK.LAUNCHES)
        check(ok.dtype == torch.bool and tuple(ok.shape) == (BATCH,),
              f"accept bits have shape {tuple(ok.shape)} and type {ok.dtype}")
        check(bool(ok.all()),
              f"mxu={mxu}: {int((~ok).sum())} honest proofs were rejected")
        check(counts[name] == n_calls,
              f"mxu={mxu}: {counts[name]} launches of {name} for {n_calls} "
              f"permutation calls")
        check(all(c == 0 for k, c in counts.items() if k != name)
              and not any(probes.LAUNCHES.values())
              and not any(bk.LAUNCHES.values()),
              f"mxu={mxu}: another kernel was launched: {counts}, "
              f"{probes.LAUNCHES}, {bk.LAUNCHES}")
        launches[name] = counts[name]
        by_lanes[name] = {n: lane_counts.count(n) for n in sorted(set(lane_counts))}
        check(by_lanes[name] == ZK20_LAUNCHES_BY_LANES,
              f"mxu={mxu}: launches by lane count {by_lanes[name]}, expected "
              f"{ZK20_LAUNCHES_BY_LANES}")
        # corrupted lanes, and only those, are rejected
        ok_bad = fn_m(pa_bad)
        check(torch.equal(ok_bad.cpu(), expect),
              f"mxu={mxu}: rejected lanes "
              f"{torch.nonzero(~ok_bad.cpu()).flatten().tolist()}, expected {lanes}")
        ch_by[mxu] = challenges_u64(F, common, digest, pa64, PERMUTES[mxu])
        check(np.array_equal(ch_by[mxu], ch_by[0]),
              f"challenges differ between mxu={mxu} and mxu=0")
    ch_kernel = ch_by[default]

    # ---- the same path with the plain permutation on the card, B = 64
    fn_plain, _ = FS.make_verifier_fn_batched(common, vk, permute=pg.permute_plain,
                                              inner_permute=pg.permute_plain)
    before = dict(pk.LAUNCHES)
    ok64_plain = fn_plain(pa64)
    ch_plain = challenges_u64(F, common, digest, pa64, pg.permute_plain)
    check(pk.LAUNCHES == before, "the plain path launched a kernel")
    check(bool(ok64.all()) and torch.equal(ok64, ok64_plain),
          "accept bits differ between the kernel's and the plain path")
    check(np.array_equal(ch_kernel, ch_plain),
          "challenges differ between the kernel's and the plain path")
    bad64 = corrupt(small, [3, 10, 20, 30, 40])
    check(torch.equal(fn_count(to_device(bad64)), fn_plain(to_device(bad64))),
          "reject bits differ between the kernel's and the plain path")

    # ---- and on the CPU (plain PyTorch ops there), first 4 proofs
    fn_cpu, to_cpu = FS.make_verifier_fn_batched(common, vk, device="cpu")
    tiny = {k: v[:4] for k, v in batched.items()}
    pa_cpu = to_cpu(tiny)
    Fc = gl64.Field("cpu")
    ch_cpu = challenges_u64(Fc, common, Fc.from_u64(vk.circuit_digest), pa_cpu,
                            pg.permute)
    check(bool(fn_cpu(pa_cpu).all()), "the CPU path rejected an honest proof")
    check(np.array_equal(ch_cpu, ch_kernel[:, :4]),
          "challenges differ between the card and the CPU")

    # ---- steady state, default variant
    reps = 5
    times = []
    reset_counts()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = fn(pa)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check(bool(ok.all()), "a repetition rejected an honest proof")
    check(pk.LAUNCHES[pk.KERNELS[default]] == reps * n_calls
          and WK.LAUNCHES["ext2_inv"] == reps * ZK20_INVERSE_LAUNCHES["ext2_inv"]
          and FK.LAUNCHES == {k: reps * c for k, c in ZK20_FIELD_LAUNCHES.items()},
          f"the default entry point launched {pk.LAUNCHES}, {WK.LAUNCHES}, {FK.LAUNCHES} "
          f"in {reps} batches")
    ms = float(np.median(times)) * 1e3
    for name in pk.KERNELS:
        rows.setdefault(name, {})["launches"] = launches[name]
    emit({"phase": "main_path", "fixture": FIXTURE.name, "distinct": distinct,
          "batch": BATCH, "wires": common.config.num_wires,
          "queries": cfg.num_query_rounds, "degree_bits": common.degree_bits,
          "zero_knowledge": common.fri_params.hiding,
          "fold_layers": len(common.fri_params.reduction_arity_bits),
          "accepted": int(ok.sum()), "rejected_lanes": lanes,
          "launches_by_variant": launches, "permutation_calls": n_calls,
          "inverse_launches": ZK20_INVERSE_LAUNCHES, "field_launches": ZK20_FIELD_LAUNCHES,
          "launches_by_lanes": by_lanes[pk.KERNELS[default]],
          "equal_across_variants": True,
          "equal_to_plain_on_card": True, "equal_to_cpu": True,
          "default_variant": pk.KERNELS[default],
          "ms_per_batch": ms, "ms_per_batch_all": [t * 1e3 for t in times],
          "ms_one_batch_by_variant": ms_once,
          "proofs_per_s": BATCH / (ms * 1e-3),
          "peak_device_bytes": torch.cuda.max_memory_allocated()})


def phase_per_proof(device):
    """make_verifier_fn and make_verifier_fn_phased on the card: the first
    4 proofs of the fixture, verified one by one under each kernel variant."""
    proofs, common, vk = load_fixture()
    n = 4
    batched = FS.batched_arrays(proofs[:n])
    fn_batched, to_device = FS.make_verifier_fn_batched(common, vk)
    pa = to_device(batched)
    # proof 2 corrupted in all five places, beside the honest proof 3
    bad = {k: v[2:4] for k, v in corrupt(batched, [2] * 5).items()}
    pa_bad = to_device(bad)
    want = fn_batched(pa)
    check(bool(want.all()), "the batched path rejected an honest proof")
    seen, seconds = {}, {}
    for mxu, name in enumerate(pk.KERNELS):
        lane_counts = []

        def recording(F_, state):
            lane_counts.append(state.numel() // 12)
            return pg.permute(F_, state, mxu)

        for maker in (FS.make_verifier_fn, FS.make_verifier_fn_phased):
            fn, _ = maker(common, vk, permute=recording,  # device="cuda"
                          inner_permute=recording)
            del lane_counts[:]
            reset_counts()
            t0 = time.perf_counter()
            ok = fn(pa)
            torch.cuda.synchronize()
            seconds[f"{maker.__name__}, mxu={mxu}"] = (time.perf_counter() - t0) / n
            check(ok.dtype == torch.bool and tuple(ok.shape) == (n,)
                  and torch.equal(ok, want),
                  f"{maker.__name__}, mxu={mxu}: bits differ from the batched path")
            check(pk.LAUNCHES[name] == len(lane_counts) > 0
                  and max(lane_counts) < 128,
                  f"{maker.__name__}, mxu={mxu}: {pk.LAUNCHES[name]} launches for "
                  f"{len(lane_counts)} calls, widest {max(lane_counts)} lanes")
            check(sum(pk.LAUNCHES.values()) == pk.LAUNCHES[name]
                  and not any(probes.LAUNCHES.values())
                  and not any(bk.LAUNCHES.values()),
                  f"{maker.__name__}, mxu={mxu}: another kernel was launched")
            seen[name] = sorted(set(lane_counts))
        ok_bad = FS.make_verifier_fn(common, vk, permute=PERMUTES[mxu],
                                     inner_permute=PERMUTES[mxu])[0](pa_bad)
        check(ok_bad.tolist() == [False, True],
              f"make_verifier_fn, mxu={mxu}: corrupted proof gave {ok_bad.tolist()}")
    emit({"phase": "per_proof", "proofs": n, "equal_to_batched": True,
          "corrupted_rejected": True, "lane_counts_by_kernel": seen,
          "launches_per_proof": len(lane_counts) // n,
          "seconds_per_proof": seconds})


def phase_bridge_kernel(device, rows):
    """bridge_permute12 against its plain version on the card at every lane
    count of the wrapped path (1, 28 and 112 a proof; 256, 7,168 and 28,672
    a batch of 256), edge values in every state position; timed by CUDA
    events at the three batch lane counts."""
    rng = np.random.default_rng(SEED + 2)
    q = 28  # FRI queries of the wrapped circuit (phase_wrapped checks it)
    lane_counts = [1, q, 4 * q, WRAPPED_BATCH, q * WRAPPED_BATCH, 4 * q * WRAPPED_BATCH]
    plain_ms, inputs = {}, {}
    for lanes in lane_counts:
        x = inputs[lanes] = gl64.from_u64(edge_state(rng, lanes), device)
        got = bk.permute(x)
        torch.cuda.synchronize()
        want, plain_ms[lanes] = timed_plain(lambda: bk.permute_plain(x))
        if not torch.equal(got, want):
            bad = int((got != want).any(0).sum())
            fail(f"bridge_permute12 != its plain version at {lanes} lanes "
                 f"({bad} lanes differ)")
    timed = {}
    for lanes in lane_counts[3:]:   # timed on the states it was compared on
        x = inputs[lanes]
        for _ in range(3):
            bk.permute(x)
        timed[lanes] = cuda_ms(lambda: bk.permute(x), 20)
    lanes = lane_counts[-1]
    t_bytes = lanes * BYTES_PER_PERMUTATION / PEAK_BYTES_PER_S * 1e3
    t_ops = lanes * BRIDGE_INT32_INSTR_PER_PERMUTATION / PEAK_INT32_INSTR_PER_S * 1e3
    # library_ms None: no PyTorch call computes this function
    rows["bridge_permute12"] = kernel_row(
        "bridge_permute12", timed[lanes], plain_ms[lanes], t_bytes, t_ops,
        lanes=lanes, ms_by_lanes=timed, plain_ms_by_lanes=plain_ms,
        permutations_per_s=lanes / (timed[lanes] * 1e-3))
    emit({"phase": "bridge_kernel", "lane_counts": lane_counts,
          "equal_to_plain": True, "bridge_permute12": rows["bridge_permute12"]})


def corrupt_wrapped(batched, lanes):
    """One bit flipped in four different places, one place per lane: an
    opening, a sibling of the merged initial walk, a fold-layer sibling,
    the final polynomial."""
    bad = {k: v.copy() for k, v in batched.items()}
    one = np.uint64(1)
    bad["open_wires"][lanes[0], 7, 1] ^= one
    bad["init_sibs_1"][lanes[1], 9, 5, 2] ^= one
    bad["step_sibs_3"][lanes[2], 20, 4, 0] ^= one
    bad["final_poly"][lanes[3], 2, 0] ^= one
    return bad


def wrapped_launches(default):
    """Every kernel's launches in one wrapped batch of 256, the nonzero ones."""
    return {"bridge_permute12": 230, default: 2, **WRAPPED_INVERSE_LAUNCHES,
            **{k: c for k, c in WRAPPED_FIELD_LAUNCHES.items() if c}}


def phase_wrapped(device, rows):
    """The bn254-wrapped path: the wrapper circuit's 16 proofs tiled to a
    batch of 256 through make_verifier_fn_batched on the card."""
    proofs, common, vk = load_proofs(WRAPPED)
    cfg = common.config.fri_config
    check(common.config.hasher == "bn254" and common.degree_bits == 13
          and cfg.num_query_rounds == 28 and cfg.cap_height == 0
          and len(proofs) == 16,
          "the fixture is not the bn254-wrapped circuit")
    distinct = len(proofs)
    while len(proofs) < WRAPPED_BATCH:
        proofs = proofs + proofs
    batched = FS.batched_arrays(proofs[:WRAPPED_BATCH])
    fn, to_device = FS.make_verifier_fn_batched(common, vk)  # device="cuda"
    pa = to_device(batched)
    lanes = [1, WRAPPED_BATCH * 3 // 10, WRAPPED_BATCH // 2, WRAPPED_BATCH - 1]
    pa_bad = to_device(corrupt_wrapped(batched, lanes))
    expect = torch.ones(WRAPPED_BATCH, dtype=torch.bool)
    expect[lanes] = False
    F = gl64.Field(device)
    digest = F.from_u64(vk.circuit_digest)

    # ---- one batch, counted
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ok = fn(pa)
    torch.cuda.synchronize()
    ms_first = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    check(ok.dtype == torch.bool and tuple(ok.shape) == (WRAPPED_BATCH,),
          f"accept bits have shape {tuple(ok.shape)} and type {ok.dtype}")
    check(bool(ok.all()), f"{int((~ok).sum())} honest wrapped proofs were rejected")
    default = pk.KERNELS[pk._use_mxu()]
    # the bridge, the public-input hash's Poseidon, the divisions' inverse,
    # the field kernels, and no other
    check(counts == wrapped_launches(default), f"launches in one wrapped batch: {counts}, "
          f"expected {wrapped_launches(default)}")
    FIELD_PATH_LAUNCHES["wrapped_batch"] = dict(FK.LAUNCHES)
    rows.setdefault("bridge_permute12", {})["launches"] = counts["bridge_permute12"]
    ok_bad = fn(pa_bad)
    check(torch.equal(ok_bad.cpu(), expect),
          f"rejected lanes {torch.nonzero(~ok_bad.cpu()).flatten().tolist()}, "
          f"expected {lanes}")

    # ---- challenges of lanes 0 and 1: the card against the CPU path
    two = {k: v[:2] for k, v in batched.items()}
    ch_card = challenges_u64(F, common, digest, to_device(two),
                             hashers.bridge_permute, pg.permute)
    Fc = gl64.Field("cpu")
    _, to_cpu = FS.make_verifier_fn_batched(common, vk, device="cpu")
    ch_cpu = challenges_u64(Fc, common, Fc.from_u64(vk.circuit_digest),
                            to_cpu(two), hashers.bridge_permute, pg.permute)
    check(np.array_equal(ch_card, ch_cpu),
          "wrapped challenges differ between the card and the CPU")

    # ---- proof 0 through the per-proof entry point
    one_fn, _ = FS.make_verifier_fn(common, vk)  # device="cuda"
    ok_one = one_fn({k: v[:1] for k, v in pa.items()})
    check(ok_one.tolist() == [True] and bool(ok[0]),
          f"make_verifier_fn gave {ok_one.tolist()} for wrapped proof 0")

    # ---- steady state
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = fn(pa)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check(bool(ok.all()), "a repetition rejected an honest wrapped proof")
    ms = float(np.median(times)) * 1e3
    emit({"phase": "wrapped", "fixture": WRAPPED.name, "distinct": distinct,
          "batch": WRAPPED_BATCH, "hasher": common.config.hasher,
          "degree_bits": common.degree_bits, "queries": cfg.num_query_rounds,
          "cap_height": cfg.cap_height,
          "fold_layers": len(common.fri_params.reduction_arity_bits),
          "gates": [type(g).__name__ for g in common.gates],
          "accepted": int(ok.sum()), "rejected_lanes": lanes,
          "launches_per_batch": counts,
          "challenges_equal_to_cpu": True, "per_proof_equal": True,
          "ms_first_batch": ms_first, "ms_per_batch": ms,
          "ms_per_batch_all": [t * 1e3 for t in times],
          "proofs_per_s": WRAPPED_BATCH / (ms * 1e-3),
          "peak_device_bytes": torch.cuda.max_memory_allocated()})


def graph_nodes(graph):
    """The node count of a captured graph: libcuda's cuGraphGetNodes on
    the graph that CompiledVerifier keeps."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    check(err == 0, f"cuGraphGetNodes failed: CUDA error {err}")
    return n.value


def launch_counts():
    """Every kernel's launch count since reset_counts(), the nonzero ones."""
    counts = {**pk.LAUNCHES, **bk.LAUNCHES, **probes.LAUNCHES, **WK.LAUNCHES,
              **FK.LAUNCHES, **NK.LAUNCHES}
    return {k: c for k, c in counts.items() if c}


def timed_s(fn, reps):
    """Host seconds of each of `reps` calls, each clock ending in a
    synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def compiled_cell(common, vk, pa, pa_bad, expect, mode="batched", eager_reps=2):
    """compiled_verifier against the eager path on one batch, clean and
    corrupted (item 8 of the module's docstring)."""
    maker = FS.make_verifier_fn_batched if mode == "batched" else FS.make_verifier_fn
    fn, _ = maker(common, vk)  # device="cuda"
    n = int(expect.numel())
    fn(pa)  # warm: libraries bound, tables uploaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        eager = fn(pa)
        torch.cuda.synchronize()
        eager_s = [time.perf_counter() - t0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eager_peak = torch.cuda.max_memory_allocated()
    eager_launches = launch_counts()
    eager_bad = fn(pa_bad)
    check(bool(eager.all()), f"{mode}: the eager path rejected an honest proof")
    check(torch.equal(eager_bad.cpu(), expect),
          f"{mode}: the eager path rejected "
          f"{torch.nonzero(~eager_bad.cpu()).flatten().tolist()}")
    eager_s += timed_s(lambda: fn(pa), eager_reps)

    # the bytes the compiled verifier keeps: its graph's pool, its buffers
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    comp = FS.compiled_verifier(common, vk, pa, mode=mode)  # device="cuda"
    compile_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    kept_bytes = torch.cuda.memory_reserved() - reserved
    counted = launch_counts()
    # the warm-up is one eager call, the capture another
    check(counted == {k: 2 * c for k, c in eager_launches.items()},
          f"{mode}: warm-up and capture counted {counted}, one eager batch "
          f"{eager_launches}")
    nodes = graph_nodes(comp.graph)

    reset_counts()
    first = comp(pa)
    kept = first.clone()
    second = comp(pa_bad)
    torch.cuda.synchronize()
    check(not launch_counts(), f"{mode}: a replay counted launches {launch_counts()}")
    check(first.dtype == torch.bool and tuple(first.shape) == (n,)
          and torch.equal(first, eager) and torch.equal(first, kept),
          f"{mode}: the replay's bits differ from the eager path's")
    check(torch.equal(second, eager_bad),
          f"{mode}: the corrupted batch's replayed bits differ from the eager path's")
    replay_s = timed_s(lambda: comp(pa), 5)
    check(torch.equal(comp(pa), eager), f"{mode}: a later replay's bits differ")
    eager_ms = float(np.median(eager_s)) * 1e3
    replay_ms = float(np.median(replay_s)) * 1e3
    return comp, {
        "mode": mode, "batch": n, "equal_to_eager": True,
        "rejected": torch.nonzero(~second.cpu()).flatten().tolist(),
        "no_sync_in_eager_batch": True, "launches_at_capture": eager_launches,
        "capture_s": comp.capture_s, "instantiate_s": comp.instantiate_s,
        "compile_s": compile_s, "graph_nodes": nodes, "peak_device_bytes": peak,
        "eager_peak_device_bytes": eager_peak, "kept_device_bytes": kept_bytes,
        "eager_ms_per_batch": eager_ms, "eager_ms_all": [t * 1e3 for t in eager_s],
        "replay_ms_per_batch": replay_ms, "replay_ms_all": [t * 1e3 for t in replay_s],
        "eager_proofs_per_s": n / (eager_ms * 1e-3),
        "replay_proofs_per_s": n / (replay_ms * 1e-3)}


def phase_compiled(device, rows):
    """The compiled verifier on the card (item 8 of the module's docstring)."""
    out = {}
    default = pk.KERNELS[pk._use_mxu()]
    proofs, common, vk = load_fixture()
    while len(proofs) < BATCH:
        proofs = proofs + proofs
    batched = FS.batched_arrays(proofs[:BATCH])
    _, to_device = FS.make_verifier_fn_batched(common, vk)
    lanes = [3, BATCH // 10, BATCH // 2, BATCH * 7 // 10, BATCH - 24]
    expect = torch.ones(BATCH, dtype=torch.bool)
    expect[lanes] = False
    pa = to_device(batched)
    comp, out["zk20"] = compiled_cell(common, vk, pa,
                                      to_device(corrupt(batched, lanes)), expect)
    zk20_launches = {default: sum(ZK20_LAUNCHES_BY_LANES.values()), **ZK20_INVERSE_LAUNCHES,
                     **{k: c for k, c in ZK20_FIELD_LAUNCHES.items() if c}}
    check(out["zk20"]["launches_at_capture"] == zk20_launches,
          f"zk20: launches at capture {out['zk20']['launches_at_capture']}, expected "
          f"{zk20_launches}")
    # a dict of another shape, or on another device, is refused
    for name, other in (("half the proofs", {k: v[: BATCH // 2] for k, v in pa.items()}),
                        ("the CPU", {k: v.cpu() for k, v in pa.items()})):
        try:
            comp(other)
        except ValueError:
            continue
        fail(f"the compiled zk20 verifier took a dict of {name}")
    out["refuses_other_shapes"] = True
    del comp

    # mode "vmap": the first 4 proofs one by one, proof 2 corrupted; the
    # per_proof phase holds the per-proof bits equal to the batched path's
    four = FS.batched_arrays(proofs[:4])
    pa4, pa4_bad = to_device(four), to_device(corrupt(four, [2] * 5))
    want4 = torch.tensor([True, True, False, True])
    fn4, _ = FS.make_verifier_fn_batched(common, vk)
    check(torch.equal(fn4(pa4_bad).cpu(), want4) and bool(fn4(pa4).all()),
          "zk20: the batched path's bits of the first 4 proofs")
    comp4, out["zk20_vmap"] = compiled_cell(common, vk, pa4, pa4_bad, want4,
                                            mode="vmap", eager_reps=0)
    del comp4

    # the bn254-wrapped batch
    wproofs, wcommon, wvk = load_proofs(WRAPPED)
    while len(wproofs) < WRAPPED_BATCH:
        wproofs = wproofs + wproofs
    wbatched = FS.batched_arrays(wproofs[:WRAPPED_BATCH])
    _, wto_device = FS.make_verifier_fn_batched(wcommon, wvk)
    wlanes = [1, WRAPPED_BATCH * 3 // 10, WRAPPED_BATCH // 2, WRAPPED_BATCH - 1]
    wexpect = torch.ones(WRAPPED_BATCH, dtype=torch.bool)
    wexpect[wlanes] = False
    wcomp, out["wrapped"] = compiled_cell(
        wcommon, wvk, wto_device(wbatched),
        wto_device(corrupt_wrapped(wbatched, wlanes)), wexpect)
    del wcomp
    check(out["wrapped"]["launches_at_capture"] == wrapped_launches(default),
          f"wrapped: launches at capture {out['wrapped']['launches_at_capture']}")
    # one field kernel a call: the graphs hold about as many nodes as launches
    for cell, most in GRAPH_NODES_AT_MOST.items():
        check(out[cell]["graph_nodes"] < most,
              f"{cell}: {out[cell]['graph_nodes']} graph nodes, expected fewer than {most}")
    emit({"phase": "compiled", **out})


def cpu_digest(pis_u64, ok):
    """digest_chain on the CPU with the plain permutation, in a process of
    its own (some 20 ms a permutation there): uint64 [4]."""
    torch.set_num_threads(1)
    F = gl64.Field("cpu")
    return F.to_u64(PB.digest_chain(F, F.from_u64(pis_u64), torch.from_numpy(ok),
                                    permute=pg.permute_plain))


# proofs of the sharded phase's make_batch_verifier leg, which verifies
# them one by one
BATCH_VERIFIER_PROOFS = 16


def phase_sharded(device):
    """The multi-rank verifier on a world of one rank. NCCL init and every
    collective run for real (a failure fails the phase); two ranks cannot
    share one card under NCCL, so the multi-rank legs (worlds 2 to 4, an
    uneven split, an empty rank) are the CPU tests' (gloo). The digests'
    CPU replays run in two processes beside the card's work."""
    store = Path(tempfile.mkdtemp()) / "store"
    check(init_distributed(f"file://{store}", 1, 0),  # device="cuda": nccl
          "init_distributed returned False")
    check(torch.distributed.get_backend() == "nccl", "the backend is not nccl")
    mesh = make_mesh(axis="data")
    proofs, common, vk = load_fixture()
    while len(proofs) < BATCH:
        proofs = proofs + proofs
    batched = FS.batched_arrays(proofs[:BATCH])
    lanes = [3, BATCH // 10, BATCH // 2, BATCH * 7 // 10, BATCH - 24]
    bad = corrupt(batched, lanes)
    expect = torch.ones(BATCH, dtype=torch.bool)
    expect[lanes] = False
    pis_u64 = batched["public_inputs"]
    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    cpu_jobs = [pool.submit(cpu_digest, pis_u64, ok.numpy())
                for ok in (torch.ones(BATCH, dtype=torch.bool), expect)]

    shard, verify_fn, agg_fn = PB.make_sharded_verifier(common, vk, mesh, batched=True)
    pa, pa_bad = shard(batched), shard(bad)
    default = pk.KERNELS[pk._use_mxu()]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ok = verify_fn(pa)
    torch.cuda.synchronize()
    verify_ms = (time.perf_counter() - t0) * 1e3
    verify_launches = pk.LAUNCHES[default]
    reset_counts()
    t0 = time.perf_counter()
    digests, count = agg_fn(pa["public_inputs"], ok)
    torch.cuda.synchronize()
    agg_ms = (time.perf_counter() - t0) * 1e3
    agg_launches = dict(pk.LAUNCHES)
    check(torch.equal(ok.cpu(), torch.ones(BATCH, dtype=torch.bool)),
          f"sharded: {int((~ok).sum())} honest proofs were rejected")
    check(verify_launches == sum(ZK20_LAUNCHES_BY_LANES.values()),
          f"sharded: {verify_launches} launches in the local verify")
    check(count == BATCH and tuple(digests.shape) == (1, 4)
          and digests.dtype == torch.int64,
          f"sharded: count {count}, digests {tuple(digests.shape)} {digests.dtype}")
    rows_perms = -(-(common.num_public_inputs + 5) // pg.RATE)
    check(agg_launches[default] == rows_perms * BATCH
          and sum(agg_launches.values()) == agg_launches[default],
          f"sharded: the digest chain launched {agg_launches}")
    # the chain's permutations by lane count
    lane_counts = []

    def recording(F_, state):
        lane_counts.append(state.numel() // 12)
        return pg.permute(F_, state)

    F = gl64.Field(device)
    again = PB.digest_chain(F, pa["public_inputs"], ok, permute=recording)
    chain_by_lanes = {n: lane_counts.count(n) for n in sorted(set(lane_counts))}
    check(chain_by_lanes == {1: rows_perms * BATCH} and torch.equal(again, digests[0]),
          f"sharded: digest chain by lanes {chain_by_lanes}")
    ok_bad = verify_fn(pa_bad)
    d_bad, count_bad = agg_fn(pa_bad["public_inputs"], ok_bad)
    check(torch.equal(ok_bad.cpu(), expect),
          f"sharded: rejected lanes {torch.nonzero(~ok_bad.cpu()).flatten().tolist()}, "
          f"expected {lanes}")
    check(count_bad == BATCH - len(lanes), f"sharded: count {count_bad} on the corrupted batch")

    # the per-proof form over the mesh, on the first proofs (lane 3 corrupted)
    n_pp = BATCH_VERIFIER_PROOFS
    fn_pp = PB.make_batch_verifier(common, vk, mesh)
    small = {k: v[:n_pp] for k, v in bad.items()}
    t0 = time.perf_counter()
    ok_pp, d_pp, count_pp = fn_pp(shard(small))
    torch.cuda.synchronize()
    batch_verifier_ms = (time.perf_counter() - t0) * 1e3
    want_pp = expect[:n_pp]
    check(not bool(want_pp.all()), "make_batch_verifier: no corrupted proof in its slice")
    check(torch.equal(ok_pp.cpu(), want_pp) and count_pp == int(want_pp.sum()),
          f"make_batch_verifier: bits {ok_pp.tolist()}, count {count_pp}")
    check(torch.equal(d_pp[0], PB.digest_chain(F, pa_bad["public_inputs"][:n_pp],
                                               want_pp.to(device))),
          "make_batch_verifier: digest differs from the chain over its rows")

    # the CPU replays, plain permutation
    cpu_clean, cpu_bad = [job.result(timeout=600) for job in cpu_jobs]
    pool.shutdown()
    check(np.array_equal(gl64.to_u64(digests[0]), cpu_clean),
          "sharded: digest differs from the CPU chain with the plain permutation")
    check(np.array_equal(gl64.to_u64(d_bad[0]), cpu_bad),
          "sharded: corrupted batch's digest differs from the CPU chain")
    emit({"phase": "sharded", "backend": "nccl", "world": 1, "batch": BATCH,
          "accepted": count, "accepted_corrupted": count_bad, "rejected_lanes": lanes,
          "verify_launches": verify_launches,
          "digest_chain_launches_by_lanes": chain_by_lanes,
          "digest": [int(x) for x in gl64.to_u64(digests[0])],
          "equal_to_cpu_plain": True, "verify_fn_ms": verify_ms, "agg_fn_ms": agg_ms,
          "batch_verifier": {"proofs": n_pp, "accepted": count_pp, "ms": batch_verifier_ms,
                             "ms_per_proof": batch_verifier_ms / n_pp}})


# the prover's coset LDEs at degree 2^13 (tools/bench_lde_backends.py:39-45)
NTT_SHAPES = [1080, 160, 128]
NTT_BITS, NTT_RATE, NTT_SHIFT = 13, 3, 7
NTT_FUNCTIONS = ("ntt", "intt", "coset_fft", "coset_ifft", "coset_lde")
# held word for word at 2 .. 2^17 points (an aggregation level's LDE), on
# both sides of the tile size, at 1 and 7 rows; and at 1,080 rows of 2^13;
# on one row, all five at 2^18 (three launches) and ntt and intt at 2^19 ..
# 2^25 (2^25 points: 256 MB, four launches), against the card's plain
# version; the CPU's too at 2^18 and, for ntt, at 2^23 (the first size of
# four launches: 17 s a call; at 2^25 a call with the CPU's took 98 s)
NTT_CHECK_BITS = range(1, 18)
NTT_CHECK_ROWS = (1, 7)
NTT_WIDE_BITS = range(18, 26)
NTT_WIDE_CPU_BITS = 23
# output bits of every transform of one prove, in call order: the 64-signal
# prove (degree 2^9, LDE 2^12; tests/test_torch_ntt_kernel.py counts its
# calls on the CPU) and the wrap of 16 (degree 2^13, LDE 2^16; listed by
# tools/torch_profile_prover.py): intt and coset_lde of the wires and of
# the zs and partial products, two coset_ifft and a coset_lde in the
# quotient, two coset_fft a FRI layer
PROVE_NTT_BITS = [9, 12, 9, 12, 12, 12, 12, 12, 12, 11, 11, 10, 10, 9, 9, 8, 8]
WRAP_NTT_BITS = [13, 16, 13, 16, 16, 16, 16, 16, 16, 15, 15, 14, 14, 13, 13, 12, 12, 11, 11,
                 10, 10, 9, 9, 8, 8]
# the provers' transforms, timed: (label, function, rows, log2 of the input
# points, arguments). The first is the widest call; then the 64-signal
# prove's (135 wires x 64 signals, degree 2^9), the wrap's (135 x 16,
# degree 2^13) and an aggregation level's FRI commit (a pair, 2^17)
NTT_TIMED = [
    ("lde 1080x2^13", "coset_lde", 1080, 13, (NTT_RATE, NTT_SHIFT)),
    ("lde 160x2^13", "coset_lde", 160, 13, (NTT_RATE, NTT_SHIFT)),
    ("lde 128x2^13", "coset_lde", 128, 13, (NTT_RATE, NTT_SHIFT)),
    ("ntt 1080x2^13", "ntt", 1080, 13, ()),
    ("prove intt", "intt", 135 * 64, 9, ()),
    ("prove coset_lde", "coset_lde", 135 * 64, 9, (NTT_RATE, NTT_SHIFT)),
    ("prove coset_ifft", "coset_ifft", 64, 12, (NTT_SHIFT,)),
    ("prove coset_fft", "coset_fft", 64, 12, (NTT_SHIFT,)),
    ("wrap intt", "intt", 135 * 16, 13, ()),
    ("wrap coset_lde", "coset_lde", 135 * 16, 13, (NTT_RATE, NTT_SHIFT)),
    ("wrap coset_ifft", "coset_ifft", 16, 16, (NTT_SHIFT,)),
    ("wrap coset_fft", "coset_fft", 16, 16, (NTT_SHIFT,)),
    ("aggregation coset_fft", "coset_fft", 2, 17, (NTT_SHIFT,)),
]
# 32-bit integer instructions, at the Poseidon count's unit costs: a
# butterfly is one field multiply, one add and one subtraction on any
# representatives (20 + 9 + 9), on the stages the function needs (an LDE
# of rate r pairs each word with 0 in its first r stages: copies, no
# arithmetic); the coset front one multiply an input word;
# the epilogue a canonicalisation (3) a point for ntt, and for intt two
# more and a multiply by 1/n (26), for coset_ifft another multiply and
# canonicalisation (49)
NTT_BUTTERFLY_INSTR = 20 + 9 + 9
NTT_EPILOGUE_INSTR = {"ntt": 3, "coset_fft": 3, "coset_lde": 3, "intt": 26, "coset_ifft": 49}
# the NTT kernels' launches by the path that made them (prove, wrap,
# aggregation), for the kernels' rows
NTT_PATH_LAUNCHES: dict = {}


def ntt_launches(bits_list) -> dict:
    """The kernels' launches for transforms of these output bits, as
    ntt_kernel.geometry decomposes them (the count a transform does not
    depend on its rows)."""
    return {"ntt_tile": len(bits_list),
            "ntt_stride": sum(len(NK.geometry(b, 1)["stride"]) for b in bits_list)}


def ntt_bound_ms(name, rows, n_in, n_out, part=None):
    """(bytes, operations) bounds of one transform, in ms, or of one of its
    kernels (`part` "ntt_tile" or "ntt_stride", all its launches): each
    input word read once and each output word written once, each
    launch's (the tables too: the twiddles, the front's powers, coset_ifft's
    inverse powers), the butterflies on every point of every stage but
    those a zero-padded input only copies (the first log2(n_out / n_in): a
    word paired with 0 comes out as it went in), the front's multiplies and
    the epilogue."""
    bits = n_out.bit_length() - 1
    tb = min(NK.TILE_BITS, bits)
    copies = NK.copy_stages(n_in, bits, bits)
    front = name in ("coset_fft", "coset_lde")
    inv_table = n_out if name == "coset_ifft" else 0
    epi_ops = n_out * NTT_EPILOGUE_INSTR[name]
    tile_ops = (n_out // 2 * (tb - min(copies, tb)) * NTT_BUTTERFLY_INSTR
                + (n_in * 20 if front else 0))
    stride_ops = n_out // 2 * (bits - max(tb, copies)) * NTT_BUTTERFLY_INSTR
    if part == "ntt_tile":
        two = bits > tb
        words = rows * (n_in + n_out) + (1 << tb) + (n_in if front else 0) + (
            0 if two else inv_table)
        ops = rows * (tile_ops + (0 if two else epi_ops))
    elif part == "ntt_stride":
        passes = len(NK.geometry(bits, rows)["stride"])
        words = passes * rows * 2 * n_out + n_out - (1 << tb) + inv_table
        ops = rows * (stride_ops + epi_ops)
    else:
        words = rows * (n_in + n_out) + n_out + (n_in if front else 0) + inv_table
        ops = rows * (tile_ops + stride_ops + epi_ops)
    return (words * 8 / PEAK_BYTES_PER_S * 1e3, ops / PEAK_INT32_INSTR_PER_S * 1e3)


def ntt_words(rng, shape, device):
    """Full-range words on the card, a quarter of them edge words (0, p - 1,
    p, p + 1, 2^64 - 1 among them: the transforms take any representative)."""
    return gl64.from_u64(field_words(rng, shape), device)


def ntt_held(x, name, args, cpu_rows=None, where=""):
    """`name` of x on the card (the kernels) against its plain version on
    the card and on the CPU (the first `cpu_rows` rows, all where None, none
    where 0), word for word; the launches it made checked against
    `ntt_launches`. Returns the kernel's output."""
    before = dict(NK.LAUNCHES)
    got = getattr(ntt, name)(x, *args)
    n_out = got.shape[-1]
    made = {k: NK.LAUNCHES[k] - before[k] for k in NK.KERNELS}
    check(made == ntt_launches([n_out.bit_length() - 1]),
          f"{name} {where}: launched {made}")
    plain = getattr(ntt, name + "_plain")
    check(torch.equal(got, plain(x, *args)),
          f"{name} {where} differs from its plain version on the card")
    xs = x if cpu_rows is None else x[:cpu_rows]
    if xs.shape[0]:
        check(torch.equal(got[:xs.shape[0]].cpu(), plain(xs.cpu(), *args)),
              f"{name} {where} differs from its plain version on the CPU")
    return got


def phase_ntt(device, rows):
    """The NTT kernels (csrc/ntt.cu) word for word against the plain
    versions on the card and on the CPU: all five functions at 2 .. 2^17
    points, 1 and 7 rows, 1,080 rows at 2^13, one row at 2^18; ntt and intt
    at 2^19 .. 2^25 on one row (the CPU at 2^23 for ntt), intt(ntt(x)) ==
    x (edge words, non-canonical ones among them, in every position);
    ntt_stride's ptxas line; coset_lde of the three 2^13 shapes
    against the numpy oracle (8 rows), intt(ntt(x)) == x, ntt_4step on a
    world of one rank equal to ntt. Then timed at the provers' shapes
    (device time from a CUDA graph, each kernel alone and the transform;
    the transform's CUDA events over 3 calls too, `call_ms`), beside the
    bounds, the launch floor, the plain version's time and the peak bytes
    of the widest LDE. The tile sizes' times: tools/torch_ntt_alternatives.py."""
    rng = np.random.default_rng(SEED + 3)
    checked = 0
    # ---- 1. every function at 2 .. 2^17 points, 1 and 7 rows
    for bits in NTT_CHECK_BITS:
        n = 1 << bits
        for r in NTT_CHECK_ROWS:
            x = ntt_words(rng, (r, n), device)
            calls = [(name, ()) for name in ("ntt", "intt")] + [
                (name, (NTT_SHIFT,)) for name in ("coset_fft", "coset_ifft")]
            calls += [("coset_lde", (rate, NTT_SHIFT)) for rate in (2, 3)
                      if bits + rate <= NTT_CHECK_BITS[-1]]
            for name, args in calls:
                ntt_held(x, name, args, where=f"[{r}, 2^{bits}] {args}")
                checked += 1
    # a strided operand (the FRI fold's coefficients) read in place
    x = ntt_words(rng, (64, 4096, 2), device)[:, :, 1]
    ntt_held(x, "coset_fft", (NTT_SHIFT,), where="strided [64, 2^12]")
    # ---- one row above 2^17 points: three launches and more
    wide = {}
    for bits in NTT_WIDE_BITS:
        x = ntt_words(rng, (1, 1 << bits), device)
        calls = [("ntt", ()), ("intt", ())] if bits > NTT_WIDE_BITS[0] else [
            ("ntt", ()), ("intt", ()), ("coset_fft", (NTT_SHIFT,)),
            ("coset_ifft", (NTT_SHIFT,)), ("coset_lde", (2, NTT_SHIFT)),
            ("coset_lde", (3, NTT_SHIFT))]
        for name, args in calls:
            # the CPU's plain version at 2^18 for all, at 2^23 for ntt
            cpu = bits == NTT_WIDE_BITS[0] or (bits == NTT_WIDE_CPU_BITS and name == "ntt")
            t0 = time.time()
            got = ntt_held(x, name, args, cpu_rows=None if cpu else 0,
                           where=f"[1, 2^{bits}] {args}")
            checked += 1
            if name == "ntt":
                check(torch.equal(ntt.intt(got), gl64.canonical(x)),
                      f"intt(ntt(x)) != x at 2^{bits}")
            wide[f"{name}{list(args)} 2^{bits}"] = {
                "launches": ntt_launches([got.shape[-1].bit_length() - 1]),
                "cpu_checked": cpu, "seconds": round(time.time() - t0, 2)}
            del got
        del x
        torch.cuda.empty_cache()
    # ---- 2. 1,080 rows at 2^13, the CPU on the first 8
    x = ntt_words(rng, (NTT_SHAPES[0], 1 << NTT_BITS), device)
    for name, args in [("ntt", ()), ("intt", ()), ("coset_fft", (NTT_SHIFT,)),
                       ("coset_ifft", (NTT_SHIFT,)), ("coset_lde", (NTT_RATE, NTT_SHIFT))]:
        ntt_held(x, name, args, cpu_rows=8, where=f"[{NTT_SHAPES[0]}, 2^{NTT_BITS}]")
        checked += 1
        torch.cuda.empty_cache()
    del x
    # ---- 3. the oracle, the inverse, the four-step transform
    for r in NTT_SHAPES:
        x_np = rng.integers(0, gl64.P, size=(r, 1 << NTT_BITS), dtype=np.uint64)
        x = gl64.from_u64(x_np, device)
        lde = ntt.coset_lde(x, NTT_RATE, NTT_SHIFT)
        check(tuple(lde.shape) == (r, (1 << NTT_BITS) << NTT_RATE),
              f"coset_lde shape {tuple(lde.shape)}")
        want = ntt_np.coset_lde(x_np[:8], NTT_RATE, NTT_SHIFT)
        check(np.array_equal(gl64.to_u64(lde[:8]), want),
              f"coset_lde [{r}, 2^{NTT_BITS}] differs from the numpy oracle")
        del lde
        check(torch.equal(ntt.intt(ntt.ntt(x)), x), f"intt(ntt(x)) != x at {r} rows")
    if not torch.distributed.is_initialized():       # --only ntt: a world of one
        store = Path(tempfile.mkdtemp()) / "store"
        check(init_distributed(f"file://{store}", 1, 0), "init_distributed returned False")
    mesh = make_mesh(axis="data")
    four = ntt.ntt_4step(x, mesh)
    check(torch.equal(four, ntt.ntt(x)), "ntt_4step on one rank differs from ntt")
    four_ms = cuda_ms(lambda: ntt.ntt_4step(x, mesh), 3)
    del x, four
    torch.cuda.empty_cache()

    # ---- 4. timed at the provers' shapes
    by_call = {}
    for label, name, r, bits, args in NTT_TIMED:
        x = ntt_words(rng, (r, 1 << bits), device)
        kw = getattr(ntt, name + "_kernel_args")(x, *args)
        n_out = kw.get("n_out", 1 << bits)
        reps = 5 if r * n_out >= 1 << 24 else 20
        if label == NTT_TIMED[0][0]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = getattr(ntt, name)(x, *args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            del out
        plain = getattr(ntt, name + "_plain")
        _, plain_ms = timed_plain(lambda: plain(x, *args))
        _, plain_ms = timed_plain(lambda: plain(x, *args))     # warm
        t_bytes, t_ops = ntt_bound_ms(name, r, 1 << bits, n_out)
        at = {"function": name, "rows": r, "points_in": 1 << bits, "points_out": n_out,
              "ms": graph_ms(lambda: getattr(ntt, name)(x, *args), reps),
              "call_ms": cuda_ms(lambda: getattr(ntt, name)(x, *args), 3),
              "plain_ms": plain_ms, "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
              **least_time(t_bytes, t_ops)}
        at["share_of_bound"] = at["bound_ms"] / at["ms"]
        # each kernel alone
        _, launches = NK.plan(x, **kw)
        for kname, launch in launches:
            kb, ko = ntt_bound_ms(name, r, 1 << bits, n_out, part=kname)
            at[kname] = {"ms": graph_ms(launch, reps), "bound_bytes_ms": kb,
                         "bound_operations_ms": ko, **least_time(kb, ko)}
        if label == NTT_TIMED[0][0]:
            at.update(peak_device_bytes=peak - base, output_bytes=r * n_out * 8,
                      points_per_s=r * n_out / (at["ms"] * 1e-3))
        by_call[label] = at
        del x, kw
        torch.cuda.empty_cache()

    # ---- the kernels' rows: the widest call
    top = by_call[NTT_TIMED[0][0]]
    for kname in NK.KERNELS:
        k = top[kname]
        rows[kname] = kernel_row(
            kname, k["ms"], top["plain_ms"], k["bound_bytes_ms"], k["bound_operations_ms"],
            call=NTT_TIMED[0][0], tile_bits=NK.TILE_BITS, transform_ms=top["ms"],
            plain_ms_is="the plain version's whole transform (both kernels' stages)",
            library_ms_is="none: no PyTorch call computes a Goldilocks NTT")
    stride_ptxas = cuda_build.ptxas_report("ntt")["ntt_stride_kernel"]
    check(all(f["spill_stores"] == 0 and f["spill_loads"] == 0 for f in stride_ptxas),
          f"ntt_stride spills: {stride_ptxas}")
    emit({"phase": "ntt", "rate_bits": NTT_RATE, "shift": NTT_SHIFT, "checks": checked,
          "check_bits": [NTT_CHECK_BITS[0], NTT_CHECK_BITS[-1]], "check_rows": NTT_CHECK_ROWS,
          "wide_one_row": wide, "ntt_stride_ptxas": stride_ptxas,
          "equal_to_plain_on_card_and_cpu": True, "equal_to_numpy": True,
          "inverse_exact": True, "tile_bits": NK.TILE_BITS, "by_call": by_call,
          "launches_per_prove": ntt_launches(PROVE_NTT_BITS),
          "launches_per_wrap": ntt_launches(WRAP_NTT_BITS),
          "ntt_4step": {"world": 1, "shape": [NTT_SHAPES[-1], 1 << NTT_BITS],
                        "equal_to_ntt": True, "ms": four_ms}})


def phase_codec(device):
    """plonky2's bytes and JSON, out and back, for proof 0 of the zk20 and of
    the wrapped fixture; the decoded proofs verified on the card."""
    out, loaded = {}, {}
    for path in (FIXTURE, WRAPPED):
        proofs, common, vk = load_proofs(path)
        loaded[path.name] = (proofs[0], common)
        want = V.proof_to_arrays(proofs[0])
        t0 = time.perf_counter()
        data = plonky2_io.proof_to_bytes(proofs[0])
        text = plonky2_io.proof_to_json(proofs[0])
        from_bytes = plonky2_io.proof_from_bytes(data, common)
        from_json = plonky2_io.proof_from_json(text)
        codec_ms = (time.perf_counter() - t0) * 1e3
        for name, decoded in (("bytes", from_bytes), ("json", from_json)):
            got = V.proof_to_arrays(decoded)
            check(got.keys() == want.keys()
                  and all(np.array_equal(got[k], want[k]) for k in want),
                  f"{path.name}: the {name} round trip changed the proof's arrays")
        flipped = plonky2_io.proof_from_bytes(data, common)
        flipped.openings.wires[0, 0] ^= np.uint64(1)
        flipped = plonky2_io.proof_from_bytes(plonky2_io.proof_to_bytes(flipped), common)
        fn, to_device = FS.make_verifier_fn(common, vk)  # device="cuda"
        t0 = time.perf_counter()
        ok = fn(to_device(FS.batched_arrays([from_bytes, from_json, flipped])))
        torch.cuda.synchronize()
        verify_s = (time.perf_counter() - t0) / 3
        check(ok.tolist() == [True, True, False],
              f"{path.name}: decoded proofs gave {ok.tolist()}, expected "
              f"[True, True, False]")
        out[path.name] = {"bytes": len(data), "json_chars": len(text),
                          "encode_decode_ms": codec_ms, "verify_s_per_proof": verify_s}
    (zk_proof, zk_common), (w_proof, w_common) = loaded.values()
    for proof, other in ((zk_proof, w_common), (w_proof, zk_common)):
        try:
            plonky2_io.proof_from_bytes(plonky2_io.proof_to_bytes(proof), other)
        except ValueError:
            continue
        fail("proof bytes decoded with another circuit's CommonData")
    emit({"phase": "codec", "round_trip_equal": True, "decoded_verified_on_card": True,
          "flipped_opening_rejected": True, "mismatched_common_raises": True,
          "by_fixture": out})


# the prover's cell: a 2^20-member access set, 64 signals at the Semaphore
# preset; the Poseidon kernels' widest launches there
PROVE_BITS = 20
PROVE_BATCH = 64
PROVE_LANES = [PROVE_BATCH * 4096, PROVE_BATCH * 8192, 1 << PROVE_BITS]
PROVE_SEEDS = (SEED + 11, SEED + 12)  # the witness and the salt rngs


def recorder(lane_counts, permute=pg.permute):
    """A permutation that records every call's lane count."""
    def recording(F_, state):
        lane_counts.append(state.numel() // 12)
        return permute(F_, state)
    return recording


def prove_rngs():
    return {"witness_rng": np.random.default_rng(PROVE_SEEDS[0]),
            "salt_rng": np.random.default_rng(PROVE_SEEDS[1])}


def transcript_before_grind(F, common, vk, proof):
    """The verifier's transcript of one proof, replayed with a plain
    Challenger up to the proof-of-work witness (not observed)."""
    pa = V.arrays_to_backend(F, V.proof_to_arrays(proof))
    pis = list(pa["public_inputs"])
    ch = Challenger(F, permute=pg.permute_plain)
    for e in F.from_u64(vk.circuit_digest):
        ch.observe_element(e)
    for e in pg.hash_no_pad(F, pis, permute=pg.permute_plain):
        ch.observe_element(e)

    def cap(c):
        ch.observe_elements([c[r, i] for r in range(c.shape[0]) for i in range(4)])

    nc = common.config.num_challenges
    cap(pa["wires_cap"])
    ch.get_n_challenges(2 * nc)
    cap(pa["zs_pp_cap"])
    ch.get_n_challenges(nc)
    cap(pa["quotient_cap"])
    ch.get_n_challenges(2)
    for b in V._opening_batches(F, pa):
        for e in b:
            ch.observe_elements([e[0], e[1]])
    ch.get_n_challenges(2)
    for i in range(pa["commit_phase_caps"].shape[0]):
        cap(pa["commit_phase_caps"][i])
        ch.get_n_challenges(2)
    ch.observe_elements([x for row in pa["final_poly"] for x in row])
    return ch


def lowest_pow_witness(F, common, vk, proof, tile=4096):
    """The least w whose squeeze after observing it has the config's
    leading zero bits: candidates scanned in order, the check a numpy
    logical shift on the uint64 words."""
    bits = common.config.fri_config.proof_of_work_bits
    ch = transcript_before_grind(F, common, vk, proof)
    base = 0
    while True:
        sim = Challenger(F, (tile,), permute=pg.permute_plain)
        sim.state = [s.expand(tile) for s in ch.state]
        sim.input_buffer = [x.expand(tile) for x in ch.input_buffer]
        sim.observe_element(torch.arange(base, base + tile, dtype=torch.int64))
        resp = F.to_u64(sim.get_challenge())
        hits = np.nonzero((resp >> np.uint64(64 - bits)) == 0)[0]
        if hits.size:
            return base + int(hits[0])
        base += tile


def cpu_prove(inputs, batch):
    """On the CPU, in a process of its own: the Semaphore circuit built,
    `batch` signals proved from `inputs` with the seeded rngs, and each
    proof's lowest proof-of-work witness found by a scan. Returns (vk cap,
    digest, the proofs' arrays, the scanned witnesses)."""
    torch.set_num_threads(1)
    data, _ = AS.build_semaphore_circuit(AS.semaphore_config(), PROVE_BITS,
                                         device="cpu")
    proofs = PV.prove_batch(data, inputs, batch, device="cpu", **prove_rngs())
    F = gl64.Field("cpu")
    scanned = [lowest_pow_witness(F, data.common, data.vk, p) for p in proofs]
    return (data.vk.constants_sigmas_cap, data.vk.circuit_digest,
            [V.proof_to_arrays(p) for p in proofs], scanned)


def proof_arrays_equal(a, b):
    return [k for k in a if not np.array_equal(np.asarray(a[k]), np.asarray(b[k]))]


def phase_prove(device):
    """The prover on the card (item 11 of the module's docstring)."""
    rng = np.random.default_rng(SEED + 9)
    n = 1 << PROVE_BITS
    sks = rng.integers(0, gl64.P, size=(n, 4), dtype=np.uint64)
    idx = rng.choice(n, size=PROVE_BATCH, replace=False)
    topics = rng.integers(0, gl64.P, size=(PROVE_BATCH, 4), dtype=np.uint64)
    check(len({tuple(t) for t in topics}) == PROVE_BATCH, "topics not distinct")
    F = gl64.Field(device)
    default = pk.KERNELS[pk._use_mxu()]
    out = {}

    # ---- 1. the access set: keys hashed, tree built, on the card
    sk_dev = F.from_u64(sks)
    set_lanes = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    pks = AS.AccessSet.public_key(sk_dev, permute=recorder(set_lanes))
    aset = AS.AccessSet(pks, AS.semaphore_config(), permute=recorder(set_lanes))
    root = aset.merkle_root  # synchronizes
    out["access_set_ms"] = (time.perf_counter() - t0) * 1e3
    check(pk.LAUNCHES[default] == len(set_lanes) == 1 + PROVE_BITS,
          f"access set: {pk.LAUNCHES} launches for {len(set_lanes)} calls")
    out["access_set_launches_by_lanes"] = {
        k: set_lanes.count(k) for k in sorted(set(set_lanes))}
    plain_tree = MerkleTree(AS.AccessSet.public_key(sk_dev, permute=pg.permute_plain),
                            0, permute=pg.permute_plain)
    check(np.array_equal(F.to_u64(plain_tree.cap[0]), root),
          "access set: the root differs from the plain permutation's tree")
    del plain_tree
    probe = torch.from_numpy(idx[:8].astype(np.int64)).to(device)
    sibs = aset.tree.prove_batch(probe)  # [8, 20, 4]
    ok = verify_merkle_proof_to_cap(
        F, list(pks[probe].T), [(probe >> k) & 1 for k in range(PROVE_BITS)],
        [list(sibs[:, k].T) for k in range(PROVE_BITS)], aset.tree.cap,
        torch.zeros(8, dtype=torch.int64, device=device))
    check(bool(ok.all()), "access set: a Merkle path failed to verify")

    # ---- 2. the circuit on the card; its CPU twin is built in the spawned
    # process below, and compared when that returns
    t0 = time.perf_counter()
    data = aset.circuit()
    out["circuit_build_ms"] = (time.perf_counter() - t0) * 1e3
    common = data.common
    check(common.degree_bits == 9 and common.config.num_wires == 135,
          f"circuit: degree 2^{common.degree_bits}, {common.config.num_wires} wires")

    # ---- 5 (started now). two signals on the CPU, beside the card's work
    inputs2, _ = aset.signal_inputs(sks[idx[:2]], topics[:2], idx[:2])
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    cpu_job = pool.submit(cpu_prove, inputs2, 2)

    # ---- 3. 64 signals on the card, counted, then again timed
    inputs, nullifiers = aset.signal_inputs(sks[idx], topics, idx)
    lanes = []
    torch.cuda.synchronize()
    reset_counts()
    counted = PV.prove_batch(data, inputs, PROVE_BATCH, permute=recorder(lanes),
                             inner_permute=recorder(lanes), **prove_rngs())
    torch.cuda.synchronize()
    check(pk.LAUNCHES[default] == len(lanes)
          and sum(pk.LAUNCHES.values()) == len(lanes)
          and not any(bk.LAUNCHES.values()) and not any(probes.LAUNCHES.values()),
          f"prove: {pk.LAUNCHES}, {bk.LAUNCHES} launches for {len(lanes)} calls")
    # the quotient's PoseidonGate constraints in one launch; the inverses of
    # the permutation argument, of L_0 and Z_H, and of the openings' points
    prove_wk = dict(WK.LAUNCHES)
    PATH_LAUNCHES["prove"] = prove_wk
    check(prove_wk["poseidon_gate_eval"] == 1 and prove_wk["gl_inv"] > 0
          and prove_wk["ext2_inv"] > 0,
          f"prove: witness.cu launches {prove_wk}")
    prove_fk = FIELD_PATH_LAUNCHES["prove"] = dict(FK.LAUNCHES)
    check(prove_fk == PROVE_FIELD_LAUNCHES,
          f"prove: field launches {prove_fk}, expected {PROVE_FIELD_LAUNCHES}")
    prove_nk = NTT_PATH_LAUNCHES["prove"] = dict(NK.LAUNCHES)
    check(prove_nk == ntt_launches(PROVE_NTT_BITS),
          f"prove: NTT launches {prove_nk}, expected {ntt_launches(PROVE_NTT_BITS)}")
    launches = {k: lanes.count(k) for k in sorted(set(lanes))}
    torch.cuda.reset_peak_memory_stats()
    stages = {}
    t0 = time.perf_counter()
    proofs = PV.prove_batch(data, inputs, PROVE_BATCH, stage_ms=stages, **prove_rngs())
    prove_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for a, b in zip(counted, proofs):
        check(not proof_arrays_equal(V.proof_to_arrays(a), V.proof_to_arrays(b)),
              "prove: two runs under the same seeds differ")
    # max_lanes: the 64 in chunks of 32 equal two proves of 32 from the same
    # two generators
    half = PROVE_BATCH // 2
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chunked = PV.prove_batch(data, inputs, PROVE_BATCH, max_lanes=half, **prove_rngs())
    torch.cuda.synchronize()
    out["max_lanes_32"] = {"prove_s": time.perf_counter() - t0,
                           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    gens = prove_rngs()
    halves = []
    for s in (0, half):
        sub = {t: v[..., s:s + half] for t, v in inputs.items()}
        halves += PV.prove_batch(data, sub, half, max_lanes=0, **gens)
    for b, (x, y) in enumerate(zip(chunked, halves)):
        diff = proof_arrays_equal(V.proof_to_arrays(x), V.proof_to_arrays(y))
        check(not diff, f"prove: max_lanes proof {b} differs from two proves of "
                        f"{half} in {diff}")
    out["max_lanes_32"]["equal_to_two_proves"] = True

    # ---- 4. verified on the card; a flipped opening rejected
    for b, p in enumerate(proofs):
        check(np.array_equal(p.public_inputs,
                             np.concatenate([root, nullifiers[b], topics[b]])),
              f"prove: proof {b}'s public inputs are not root ‖ nullifier ‖ topic")
    fn, to_device = FS.make_verifier_fn_batched(common, data.vk)  # device="cuda"
    batched = FS.batched_arrays(proofs)
    ok = fn(to_device(batched))
    check(bool(ok.all()), f"prove: {int((~ok).sum())} of the card's proofs rejected")
    bad = {k: v.copy() for k, v in batched.items()}
    bad["open_wires"][5, 0, 0] ^= np.uint64(1)
    expect = torch.ones(PROVE_BATCH, dtype=torch.bool)
    expect[5] = False
    ok_bad = fn(to_device(bad))
    check(torch.equal(ok_bad.cpu(), expect),
          f"prove: rejected {torch.nonzero(~ok_bad.cpu()).flatten().tolist()}, expected [5]")
    signals = [AS.Signal(topics=topics[0], nullifier=nullifiers[0], proof=proofs[0]),
               AS.Signal(topics=topics[1] ^ np.uint64(1), nullifier=nullifiers[1],
                         proof=proofs[1])]
    check(aset.verify_signals_np(signals) == [True, False],
          "prove: verify_signals_np on the card did not accept signal 0 alone")

    # ---- 5. two signals: kernel, plain permutation on the card, the CPU
    two_kernel = PV.prove_batch(data, inputs2, 2, **prove_rngs())
    before = dict(pk.LAUNCHES)
    two_plain = PV.prove_batch(data, inputs2, 2, permute=pg.permute_plain,
                               inner_permute=pg.permute_plain, **prove_rngs())
    check(pk.LAUNCHES == before, "prove: the plain run launched a kernel")
    # ---- 6. the kernels at the prover's lane counts (while the CPU works)
    kernel_times = prove_kernels(device)
    cpu_cap, cpu_digest_, cpu_arrays, scanned = cpu_job.result(timeout=900)
    pool.shutdown()
    check(np.array_equal(cpu_cap, data.vk.constants_sigmas_cap)
          and np.array_equal(cpu_digest_, data.vk.circuit_digest),
          "circuit: the card's verifying key differs from the CPU build's")
    for b in range(2):
        want = V.proof_to_arrays(two_kernel[b])
        for name, got in (("plain on the card", V.proof_to_arrays(two_plain[b])),
                          ("the CPU", cpu_arrays[b])):
            diff = proof_arrays_equal(want, got)
            check(not diff, f"prove: proof {b} differs from {name} in {diff}")
        check(int(two_kernel[b].opening_proof.pow_witness) == scanned[b],
              f"prove: grind witness {int(two_kernel[b].opening_proof.pow_witness)}"
              f" is not the lowest, {scanned[b]}")
    RECURSION_INPUTS.update(aset=aset, signals=[
        AS.Signal(topics=topics[b], nullifier=nullifiers[b], proof=proofs[b])
        for b in range(RECURSION_SIGNALS)])
    emit({"phase": "prove", "members": n, "batch": PROVE_BATCH,
          "degree_bits": common.degree_bits, "wires": common.config.num_wires,
          "queries": common.config.fri_config.num_query_rounds,
          "pow_bits": common.config.fri_config.proof_of_work_bits,
          "zero_knowledge": common.fri_params.hiding, **out,
          "prove_s": prove_s, "proofs_per_s": PROVE_BATCH / prove_s,
          "stage_ms": stages, "launches": len(lanes), "launches_by_lanes": launches,
          "witness_cu_launches": prove_wk, "field_launches": prove_fk,
          "ntt_launches": prove_nk,
          "peak_device_bytes": peak, "accepted": int(ok.sum()), "rejected_lane": 5,
          "equal_kernel_plain_cpu": True, "vk_equal_to_cpu": True,
          "grind_witnesses": scanned, "kernels_by_lanes": kernel_times})


def prove_kernels(device):
    """The three Poseidon kernels against the plain version at the
    prover's widest lane counts, and timed there in turns (device time,
    CUDA-graph replay), each beside its bound."""
    rng = np.random.default_rng(SEED + 10)
    by_lanes = {}
    for lanes in PROVE_LANES:
        x = gl64.from_u64(edge_state(rng, lanes), device)
        want = pk.permute_plain(x)
        for mxu, name in enumerate(pk.KERNELS):
            check(torch.equal(pk.permute(x, mxu), want),
                  f"{name} != permute_plain at {lanes} lanes")
        del want
        timed = {}
        for mxu in (0, 1, 2, 2, 1, 0):
            t = graph_ms(lambda: pk.permute(x, mxu), 10)
            name = pk.KERNELS[mxu]
            timed[name] = min(t, timed.get(name, t))
        bound = max(poseidon_bound_ms(lanes))
        by_lanes[lanes] = {"bound_ms": bound, **{
            name: {"ms": t, "share_of_bound": bound / t} for name, t in timed.items()}}
    return by_lanes


# ------------------------------------------------------------- recursion
RECURSION_SIGNALS = 4
RECURSION_INPUTS: dict = {}   # the prove phase's access set and first signals
WRAP_BATCH = 16
FILL_LANES = [1, 16, 64, 1025]           # 1,025: a ragged count
CHAIN_LANES = [1, 16, 64]
# the steps of the longest Reducing row, at which the kernels line reads the
# chain; 32, 33, 64, 100: the edges of the kernel's chunks of 32 steps and
# of its pairs of chunks
REDUCING_STEPS = 43
CHAIN_STEPS = [1, 32, 33, REDUCING_STEPS, 64, 100]
# the lane counts at which a path launches the two witness kernels: one
# signal's wrap and the top aggregation level (1), the first level's two
# pairs (2), a wrap of 16, the prove phase's 64 signals
WITNESS_PATH_LANES = [1, 2, WRAP_BATCH, PROVE_BATCH]


def recursion_inputs(device):
    """The prove phase's access set and first signals; under `--only
    recursion`, the same set built here (its 2^20 keys from the same seed)
    and RECURSION_SIGNALS signals proved with the seeded rngs."""
    if not RECURSION_INPUTS:
        rng = np.random.default_rng(SEED + 9)
        n = 1 << PROVE_BITS
        sks = rng.integers(0, gl64.P, size=(n, 4), dtype=np.uint64)
        idx = rng.choice(n, size=PROVE_BATCH, replace=False)[:RECURSION_SIGNALS]
        topics = rng.integers(0, gl64.P, size=(PROVE_BATCH, 4),
                              dtype=np.uint64)[:RECURSION_SIGNALS]
        aset = AS.AccessSet(AS.AccessSet.public_key(gl64.from_u64(sks, device)),
                            AS.semaphore_config())
        RECURSION_INPUTS.update(aset=aset, signals=aset.make_signals(
            sks[idx], topics, idx, **prove_rngs()))
    return RECURSION_INPUTS["aset"], RECURSION_INPUTS["signals"]


def fill_bound_ms(lanes):
    return (lanes * FILL_BYTES_PER_LANE / PEAK_BYTES_PER_S * 1e3,
            lanes * FILL_INT32_INSTR_PER_LANE / PEAK_INT32_INSTR_PER_S * 1e3)


def chain_bound_ms(lanes, k):
    return (lanes * (4 + 4 * k) * 8 / PEAK_BYTES_PER_S * 1e3,
            lanes * k * CHAIN_INT32_INSTR_PER_STEP / PEAK_INT32_INSTR_PER_S * 1e3)


def witness_kernels(device):
    """poseidon_gate_fill and ext2_reduce_chain against their plain versions
    on the card (edge words, non-canonical ones among them; swap 0 and 1,
    half of each as the non-canonical word p or p + 1; base and extension
    coefficients), then timed at the lane counts the paths launch them at,
    each beside its bound and the launch floor there: device time (50
    launches replayed from a CUDA graph) and the eager call's time (100
    calls between CUDA events; the wrapper's host work, where it is longer
    than the kernel)."""
    rng = np.random.default_rng(SEED + 15)
    fill, chain = {}, {}
    for lanes in sorted(set(FILL_LANES + WITNESS_PATH_LANES)):
        ins = gl64.from_u64(edge_state(rng, lanes), device)
        for bit in (0, 1):
            sw_np = np.full(lanes, bit, np.uint64)
            sw_np[::2] += np.uint64(gl64.P)
            sw = gl64.from_u64(sw_np, device)
            got = WK.poseidon_gate_fill(ins, sw)
            want, plain_ms = timed_plain(lambda: WK.poseidon_gate_fill_plain(ins, sw))
            check(torch.equal(got, want),
                  f"poseidon_gate_fill != its plain version at {lanes} lanes, swap {bit}")
        t_bytes, t_ops = fill_bound_ms(lanes)
        fill[lanes] = {"ms": graph_ms(lambda: WK.poseidon_gate_fill(ins, sw), 50),
                       "call_ms": cuda_ms(lambda: WK.poseidon_gate_fill(ins, sw), 100),
                       "plain_ms": plain_ms, "bound_bytes_ms": t_bytes,
                       "bound_operations_ms": t_ops, **least_time(t_bytes, t_ops)}
    for lanes in sorted(set(CHAIN_LANES + WITNESS_PATH_LANES)):
        for k in CHAIN_STEPS:
            for ext in (False, True):
                a, x = (gl64.from_u64(edge_state(rng, lanes)[:2], device) for _ in range(2))
                c_np = np.stack([edge_state(rng, lanes)[:2] for _ in range(k)])
                if not ext:
                    c_np[:, 1] = 0
                c = gl64.from_u64(c_np, device)
                got = WK.ext2_reduce_chain(a, x, c)
                want, plain_ms = timed_plain(lambda: WK.ext2_reduce_chain_plain(a, x, c))
                check(torch.equal(got, want),
                      f"ext2_reduce_chain != its plain version at {lanes} lanes, "
                      f"k = {k}, {'extension' if ext else 'base'} coefficients")
            t_bytes, t_ops = chain_bound_ms(lanes, k)
            chain[f"{lanes}x{k}"] = {"ms": graph_ms(lambda: WK.ext2_reduce_chain(a, x, c), 50),
                                     "call_ms": cuda_ms(lambda: WK.ext2_reduce_chain(a, x, c),
                                                        100),
                                     "plain_ms": plain_ms, "bound_bytes_ms": t_bytes,
                                     "bound_operations_ms": t_ops,
                                     **least_time(t_bytes, t_ops)}
    return fill, chain


# lane counts at which the paths launch the three later kernels of
# witness.cu: ext2_arith on the recursive witnesses (WITNESS_PATH_LANES);
# gl_inv there too, and on a prove's [10 chunks, B, n] denominators (64 x
# 2^9 at the prove, 16 x 2^13 at the wrap) and the LDE's 2^16 points;
# ext2_inv on the witnesses and the verifier's [B] and [B, 28] (zk20 1024,
# wrapped 256); poseidon_gate_eval on a quotient's [B, lde_n]: a prove of 64
# (2^12 points), a level's pair (2^17), a wrap of 16 (2^16)
ARITH_LANES = WITNESS_PATH_LANES + [1025]
GL_INV_LANES = WITNESS_PATH_LANES + [1 << 16, 10 * PROVE_BATCH << 9, 10 * WRAP_BATCH << 13]
EXT2_INV_LANES = WITNESS_PATH_LANES + [BATCH, 28 * WRAPPED_BATCH, 28 * BATCH]
EVAL_SHAPES = [(PROVE_BATCH, 1 << 12), (2, 1 << 17), (WRAP_BATCH, 1 << 16)]


def lane_bound_ms(lanes, bytes_per_lane, instr_per_lane):
    return (lanes * bytes_per_lane / PEAK_BYTES_PER_S * 1e3,
            lanes * instr_per_lane / PEAK_INT32_INSTR_PER_S * 1e3)


def timed_kernel(fn, plain_ms, bounds, reps=50):
    """Device time (CUDA-graph replay) and eager time of `fn`, beside its
    plain version's time and its bounds."""
    t_bytes, t_ops = bounds
    return {"ms": graph_ms(fn, reps), "call_ms": cuda_ms(fn, min(reps, 20)),
            "plain_ms": plain_ms, "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
            **least_time(t_bytes, t_ops)}


def dependent_instruction_ns(device):
    """The least time between an instruction and one that reads its
    result, in ns: one warp of alu_probe's one-chain loop for mad_wide_u32
    (one IMAD.WIDE.U32 a step) and cmp_add_u32 (a compare and the add it
    guards: two a step), each at 512 and 4,608 steps from a CUDA graph, the
    difference over 4,096 steps; the lesser of the two."""
    rng = np.random.default_rng(SEED + 17)
    per = {}
    for op, a_step in (("mad_wide_u32", 1), ("cmp_add_u32", 2)):
        x = probes.alu_input(op, 32, rng, device)
        t = [graph_ms(lambda c=c: probes.alu_probe(x, op, c, 1), 20) for c in (512, 4608)]
        per[op] = (t[1] - t[0]) * 1e6 / 4096 / a_step
    return min(per.values()), per


def critical_path_bound(device, kernel):
    """One lane's longest chain of dependent instructions in `kernel` of
    witness.cu's built library (`sass.critical_path`), at the least latency
    a dependent instruction takes on this card: no launch of any width is
    shorter. None without cuobjdump."""
    listing = sass.listings(cuda_build._target("witness"))
    if listing is None:
        return None
    ident = f"{kernel}_kernel"
    (fn,) = [k for k in listing if k.startswith(f"_Z{len(ident)}{ident}")]
    depth = sass.critical_path(listing[fn])
    ns, by_op = dependent_instruction_ns(device)
    return {"dependent_instructions": depth, "ns_a_dependent_instruction": ns,
            "ns_by_chain": by_op, "ms": depth * ns * 1e-6}


def c_plane_kernels(device):
    """ext2_arith, gl_inv, ext2_inv and poseidon_gate_eval against their
    plain versions on the card, exactly (edge words in every operand,
    non-canonical ones among them; the constant pairs 0, 1, p - 1, a small
    and a large one; the eval on random wires and on wires the fill made,
    whose constraints are all 0), then timed at the lane counts the paths
    launch them at, each beside its bound and the launch floor."""
    rng = np.random.default_rng(SEED + 16)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 16)
    edges = gl64.from_u64(EDGES, device)
    consts = [0, 1, gl64.P - 1, 7, 2**63 + 5]
    arith, gl_inv, ext2_inv, evals = {}, {}, {}, {}

    def words(shape):
        """Full-range words made on the card, a quarter of them edge words."""
        w = torch.randint(-2**63, 2**63 - 1, shape, dtype=torch.int64, device=device,
                          generator=gen)
        pick = torch.rand(shape, device=device, generator=gen) < 0.25
        at = torch.randint(0, len(EDGES), shape, device=device, generator=gen)
        return torch.where(pick, edges[at], w)

    for lanes in ARITH_LANES:
        x, y, z = words((2, lanes)), words((2, lanes)), words((2, lanes))
        for c0 in consts:
            for c1 in consts:
                check(torch.equal(WK.ext2_arith(c0, c1, x, y, z),
                                  WK.ext2_arith_plain(c0, c1, x, y, z)),
                      f"ext2_arith != its plain version at {lanes} lanes, c = {c0}, {c1}")
        c0, c1 = 2**63 + 5, gl64.P - 1
        _, plain_ms = timed_plain(lambda: WK.ext2_arith_plain(c0, c1, x, y, z))
        arith[lanes] = timed_kernel(lambda: WK.ext2_arith(c0, c1, x, y, z), plain_ms,
                                    lane_bound_ms(lanes, ARITH_BYTES_PER_LANE,
                                                  ARITH_INT32_INSTR_PER_LANE))
    for lanes in GL_INV_LANES:
        a = words((lanes,))
        if lanes >= len(EDGES):
            a[:len(EDGES)] = edges
        want, plain_ms = timed_plain(lambda: WK.gl_inv_plain(a))
        check(torch.equal(WK.gl_inv(a), want), f"gl_inv != its plain version at {lanes} lanes")
        gl_inv[lanes] = timed_kernel(lambda: WK.gl_inv(a), plain_ms,
                                     lane_bound_ms(lanes, INV_BYTES_PER_LANE,
                                                   INV_INT32_INSTR_PER_LANE))
    for lanes in EXT2_INV_LANES:
        a = words((2, lanes))
        if lanes >= len(EDGES) ** 2:     # every pair of edge words
            a[0, :len(EDGES) ** 2] = gl64.from_u64(np.repeat(EDGES, len(EDGES)), device)
            a[1, :len(EDGES) ** 2] = gl64.from_u64(np.tile(EDGES, len(EDGES)), device)
        want, plain_ms = timed_plain(lambda: WK.ext2_inv_plain(a))
        check(torch.equal(WK.ext2_inv(a), want),
              f"ext2_inv != its plain version at {lanes} lanes")
        ext2_inv[lanes] = timed_kernel(lambda: WK.ext2_inv(a), plain_ms,
                                       lane_bound_ms(lanes, EXT2_INV_BYTES_PER_LANE,
                                                     EXT2_INV_INT32_INSTR_PER_LANE))
    # a bound at every width: the addition chain's dependent multiplies
    # (latency, where the bounds above count throughput), for both inverses
    for kernel, by_lanes in (("gl_inv", gl_inv), ("ext2_inv", ext2_inv)):
        path = critical_path_bound(device, kernel)
        for at in by_lanes.values():
            at["critical_path"] = path
            if path is not None:
                larger = max(at["bound_ms"], path["ms"])
                by = ("latency" if path["ms"] > at["bound_ms"] else "bytes"
                      if at["bound_bytes_ms"] >= at["bound_operations_ms"] else "operations")
                at.update(larger_bound_ms=larger, share_of_larger_bound=larger / at["ms"],
                          larger_bound_by=by)
    ins = gl64.from_u64(edge_state(rng, 1025), device)
    sw = gl64.from_u64(rng.integers(0, 2, 1025, dtype=np.uint64), device)
    honest = WK.poseidon_gate_fill(ins, sw)
    check(not bool(WK.poseidon_gate_eval(honest).any()),
          "poseidon_gate_eval: the fill's wires break a constraint")
    for shape in EVAL_SHAPES:
        lanes = shape[0] * shape[1]
        # the quotient's layout: the planes are slices of one wire tensor
        wires = words((WK.FILL_WIRES + 1,) + shape)
        planes = list(wires)[:WK.FILL_WIRES]
        want, plain_ms = timed_plain(lambda: WK.poseidon_gate_eval_plain(planes))
        check(torch.equal(WK.poseidon_gate_eval(planes), want),
              f"poseidon_gate_eval != its plain version at {shape}")
        del want
        evals[f"{shape[0]}x{shape[1]}"] = timed_kernel(
            lambda: WK.poseidon_gate_eval(planes), plain_ms,
            lane_bound_ms(lanes, EVAL_BYTES_PER_LANE, EVAL_INT32_INSTR_PER_LANE), reps=5)
        del wires, planes
    return arith, gl_inv, ext2_inv, evals


def ext_arith_generators(data):
    """The circuit's ArithmeticExtension and MulExtension generators: one
    ext2_arith launch each in a witness."""
    return sum(1 for g in data.builder.generators if g.__qualname__.startswith(
        ("CircuitBuilder.arithmetic_extension.", "CircuitBuilder.mul_extension.")))


def gate_rows(data, *kinds):
    return sum(1 for g, _ in data.builder.gate_rows if isinstance(g, kinds))


# the first aggregation level proved again in spawned workers (one pair
# each), and in chunks of one pair in this process from the same children
AGG_PROCS = 2
AGG_WORKER_SEEDS = (SEED + 15, SEED + 16)   # the witness and the salt rngs


def aggregation_workers(level, proofs, inner_vk, one_batch_s):
    """The level of `proofs` (two pairs) proved (a) with procs=AGG_PROCS,
    spawned workers on this card, generators seeded AGG_WORKER_SEEDS;
    (b) a chunk of one pair at a time in this process (max_pairs=1), chunk k
    from the children (a) gave worker k; beside (c), the one-batch prove of
    the same level (`one_batch_s`). (a) equals (b) array by array and in
    its launches (the workers' merged into this process's counters); (a)'s
    proofs pass the port's verifier on the card; a child with a flipped
    word makes a worker raise, which comes back as RuntimeError."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # the parent's cached blocks, freed for the workers
    gens = [np.random.default_rng(s) for s in AGG_WORKER_SEEDS]
    workers = []
    reset_counts()
    t0 = time.perf_counter()
    spawned = SREC.prove_aggregation_level(level, proofs, inner_vk, procs=AGG_PROCS,
                                           worker_stats=workers, witness_rng=gens[0],
                                           salt_rng=gens[1])
    spawned_s = time.perf_counter() - t0
    spawned_launches = launch_counts()
    check([w["pairs"] for w in workers] == [(0, 1), (1, 2)],
          f"aggregation workers: chunks {[w['pairs'] for w in workers]}")
    children = [np.random.default_rng(s).spawn(AGG_PROCS) for s in AGG_WORKER_SEEDS]
    here = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for k in range(AGG_PROCS):
        here += SREC.prove_aggregation_level(
            level, proofs[2 * k:2 * k + 2], inner_vk, max_pairs=1, procs=1,
            witness_rng=children[0][k], salt_rng=children[1][k])
    torch.cuda.synchronize()
    here_s = time.perf_counter() - t0
    here_launches = launch_counts()
    check(len(spawned) == len(here) == AGG_PROCS,
          f"aggregation workers: {len(spawned)} and {len(here)} proofs")
    for b, (got, want) in enumerate(zip(spawned, here)):
        diff = proof_arrays_equal(V.proof_to_arrays(want), V.proof_to_arrays(got))
        check(not diff, f"aggregation workers: proof {b} differs from the chunk proved "
                        f"here in {diff}")
    check(spawned_launches == here_launches,
          f"aggregation workers: launches {spawned_launches}, proved here {here_launches}")
    F = gl64.Field(level.data.device)
    ok = [bool(V.verify_proof(F, level.data.common, level.data.vk, p)) for p in spawned]
    check(all(ok), f"aggregation workers: verify_proof on the card gave {ok}")
    bad = [copy.deepcopy(p) for p in proofs]
    bad[1].openings.wires[0, 0] ^= np.uint64(1)
    t0 = time.perf_counter()
    try:
        SREC.prove_aggregation_level(level, bad, inner_vk, procs=AGG_PROCS)
        fail("aggregation workers: a child with a flipped opening was aggregated")
    except RuntimeError as e:
        check("WitnessConflict" in str(e),
              f"aggregation workers: a flipped child raised {str(e)[-400:]}")
    failed_s = time.perf_counter() - t0
    return {"procs": AGG_PROCS, "pairs": len(spawned),
            "worker_start_s": [w["start_s"] for w in workers],
            "worker_rebuild_s": [w["rebuild_s"] for w in workers],
            "worker_prove_s": [w["prove_s"] for w in workers],
            "worker_result_s": [w["result_s"] for w in workers],
            "worker_stage_ms": [w["stage_ms"] for w in workers],
            "spawn_to_result_s": spawned_s,
            "prove_s": {"workers": spawned_s, "chunks_here": here_s, "one_batch": one_batch_s},
            "launches": spawned_launches, "equal_to_chunks_here": True,
            "accepted_on_card": sum(ok), "flipped_child_raised_s": failed_s}


def phase_recursion(device, rows):
    """Recursion on the card: the witness kernels against their plain
    versions; the bn254 wrapper of the zk20 circuit rebuilding
    sem_wrapped16.npz; verify_signal; the aggregation tree at the
    reference's strength; the digest aggregation and its attestation."""
    out = {}
    fill, chain = witness_kernels(device)
    arith, gl_inv, ext2_inv, evals = c_plane_kernels(device)

    # ---- (a) the wrapper at full width, against the tracked fixture
    zk_proofs, common, vk = load_fixture()
    w_proofs, w_common, w_vk = load_proofs(WRAPPED)
    t0 = time.perf_counter()
    wrap = SREC.build_wrapper_circuit(common, hasher="bn254")  # device="cuda"
    out["wrapper_build_s"] = time.perf_counter() - t0
    wd = wrap.data
    check(wd.common.to_json() == w_common.to_json(),
          "wrapper: its CommonData differs from sem_wrapped16.npz's")
    check(np.array_equal(wd.vk.circuit_digest, w_vk.circuit_digest)
          and np.array_equal(wd.vk.constants_sigmas_cap, w_vk.constants_sigmas_cap),
          "wrapper: its verifying key differs from sem_wrapped16.npz's")
    bridge_lanes, poseidon_lanes, stages = [], [], {}
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wrapped = wrap.prove(zk_proofs[:WRAP_BATCH], vk, stage_ms=stages,
                         permute=recorder(bridge_lanes, hashers.bridge_permute),
                         inner_permute=recorder(poseidon_lanes))
    torch.cuda.synchronize()
    wrap_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = {**pk.LAUNCHES, **bk.LAUNCHES, **WK.LAUNCHES}
    FIELD_PATH_LAUNCHES["wrap"] = dict(FK.LAUNCHES)
    NTT_PATH_LAUNCHES["wrap"] = dict(NK.LAUNCHES)
    check(NTT_PATH_LAUNCHES["wrap"] == ntt_launches(WRAP_NTT_BITS),
          f"wrap: NTT launches {NTT_PATH_LAUNCHES['wrap']}, expected "
          f"{ntt_launches(WRAP_NTT_BITS)}")
    default = pk.KERNELS[pk._use_mxu()]
    fills = gate_rows(wd, G.PoseidonGate)
    chains = gate_rows(wd, G.ReducingGate, G.ReducingExtensionGate)
    ariths = ext_arith_generators(wd)
    inverses = counts["gl_inv"] + counts["ext2_inv"]
    # one quotient, one PoseidonGate evaluation; the inverses of the witness's
    # in-circuit divisions and of the prover's, however many there are
    check(counts["bridge_permute12"] == len(bridge_lanes)
          and counts[default] == len(poseidon_lanes)
          and counts["poseidon_gate_fill"] == fills
          and counts["ext2_reduce_chain"] == chains
          and counts["ext2_arith"] == ariths and counts["poseidon_gate_eval"] == 1
          and counts["gl_inv"] > 0 and counts["ext2_inv"] > 0
          and sum(counts.values()) == (len(bridge_lanes) + len(poseidon_lanes) + fills
                                       + chains + ariths + 1 + inverses),
          f"wrap: launches {counts} for {len(bridge_lanes)} bridge and "
          f"{len(poseidon_lanes)} Poseidon calls, {fills} fill and {chains} chain rows, "
          f"{ariths} extension-arithmetic generators")
    for name in WK.KERNELS:
        rows[name] = {"launches": counts[name]}
    check(len(wrapped) == WRAP_BATCH, f"wrap: {len(wrapped)} proofs")
    for b, (got, want) in enumerate(zip(wrapped, w_proofs)):
        diff = proof_arrays_equal(V.proof_to_arrays(want), V.proof_to_arrays(got))
        check(not diff, f"wrap: proof {b} differs from sem_wrapped16.npz's in {diff}")
    fn, to_device = FS.make_verifier_fn_batched(wd.common, wd.vk)  # device="cuda"
    batched = FS.batched_arrays(wrapped)
    ok = fn(to_device(batched))
    check(bool(ok.all()), f"wrap: {int((~ok).sum())} wrapped proofs rejected on the card")
    bad = {k: v.copy() for k, v in batched.items()}
    bad["open_wires"][5, 0, 0] ^= np.uint64(1)
    expect = torch.ones(WRAP_BATCH, dtype=torch.bool)
    expect[5] = False
    ok_bad = fn(to_device(bad))
    check(torch.equal(ok_bad.cpu(), expect),
          f"wrap: rejected {torch.nonzero(~ok_bad.cpu()).flatten().tolist()}, expected [5]")
    child = copy.deepcopy(zk_proofs[0])
    child.openings.wires[0, 0] ^= np.uint64(1)
    t0 = time.perf_counter()
    try:
        wrap.prove([child], vk)
        fail("wrap: a child with a flipped opening was wrapped")
    except WitnessConflict:
        pass
    out["witness_conflict_s"] = time.perf_counter() - t0
    out["wrap"] = {
        "batch": WRAP_BATCH, "degree_bits": wd.common.degree_bits,
        "generators": len(wd.builder.generators),
        "gate_rows": {name: gate_rows(wd, getattr(G, name)) for name in (
            "PoseidonGate", "ArithmeticExtensionGate", "ArithmeticGate", "RandomAccessGate",
            "ReducingGate", "ReducingExtensionGate", "ConstantGate", "NoopGate")},
        "prove_s": wrap_s, "proofs_per_s": WRAP_BATCH / wrap_s, "stage_ms": stages,
        "peak_device_bytes": peak, "field_launches": FIELD_PATH_LAUNCHES["wrap"],
        "ntt_launches": NTT_PATH_LAUNCHES["wrap"],
        "launches_by_lanes": {
            "bridge_permute12": {n: bridge_lanes.count(n) for n in sorted(set(bridge_lanes))},
            default: {n: poseidon_lanes.count(n) for n in sorted(set(poseidon_lanes))},
            "poseidon_gate_fill": {WRAP_BATCH: fills},
            "ext2_reduce_chain": {WRAP_BATCH: chains},
            "ext2_arith": {WRAP_BATCH: ariths},
            "poseidon_gate_eval": {WRAP_BATCH << 16: 1},
            "gl_inv": counts["gl_inv"], "ext2_inv": counts["ext2_inv"]},
        "equal_to_fixture": True, "accepted_on_card": int(ok.sum()), "rejected_lane": 5}
    del batched, bad, ok, ok_bad

    # ---- (b) verify_signal on the prove phase's set and signal
    aset, signals = recursion_inputs(device)
    sd = aset.circuit()
    if (sd.common.to_json() == common.to_json()
            and np.array_equal(sd.vk.circuit_digest, vk.circuit_digest)):
        aset._wrapper = wrap     # the same inner circuit: the wrapper built above
    answers, answer_s = [], []
    flipped = copy.deepcopy(signals[0])
    flipped.proof.openings.wires[0, 0] ^= np.uint64(1)
    forged = copy.deepcopy(signals[0])
    forged.nullifier = forged.nullifier ^ np.uint64(1)
    for sig in (signals[0], flipped, forged):
        t0 = time.perf_counter()
        answers.append(aset.verify_signal(sig))
        answer_s.append(time.perf_counter() - t0)
    check(answers == [True, False, False],
          f"verify_signal: {answers} for (honest, flipped opening, forged nullifier)")
    out["verify_signal"] = {"answers": answers, "seconds": answer_s,
                            "wrapper_reused": aset._wrapper is wrap}

    # ---- (c) aggregation of 4 signals at the reference's strength
    cfg = recursion_config(aset.config.fri_config, zero_knowledge=True)
    # the levels' circuits are built first, each counted on its own (their
    # constants trees and digests launch Poseidon, and nothing else), and
    # handed to aggregate_signals through its cache
    cache, builds = {}, []
    level_common = aset.circuit().common
    for _ in range(RECURSION_SIGNALS.bit_length() - 1):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        level = SREC.build_aggregation_circuit(level_common, cfg)  # device="cuda"
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        built = {**pk.LAUNCHES, **bk.LAUNCHES, **WK.LAUNCHES}
        check(built[default] > 0 and sum(built.values()) == built[default],
              f"aggregation: a level's build launched {built}")
        builds.append({"build_s": build_s, "build_poseidon_launches": built[default]})
        cache[id(level_common)] = level
        level_common = level.data.common
    stats, agg_lanes = [], []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    agg = SREC.aggregate_signals(
        aset, signals[:RECURSION_SIGNALS], config=cfg, level_stats=stats, _cache=cache,
        witness_rng=np.random.default_rng(SEED + 13),
        salt_rng=np.random.default_rng(SEED + 14), procs=1,
        permute=recorder(agg_lanes), inner_permute=recorder(agg_lanes))
    torch.cuda.synchronize()
    agg_s = time.perf_counter() - t0
    for st, built in zip(stats, builds):
        st.update(built)
    agg_counts = {**pk.LAUNCHES, **bk.LAUNCHES, **WK.LAUNCHES}
    FIELD_PATH_LAUNCHES["aggregation"] = dict(FK.LAUNCHES)
    NTT_PATH_LAUNCHES["aggregation"] = dict(NK.LAUNCHES)
    agg_launches = {**WK.LAUNCHES, default: agg_counts[default]}
    agg_fills = sum(st["gate_rows"]["PoseidonGate"] for st in stats)
    agg_chains = sum(st["gate_rows"].get(g, 0) for st in stats
                     for g in ("ReducingGate", "ReducingExtensionGate"))
    agg_ariths = sum(ext_arith_generators(level.data) for level in cache.values())
    agg_others = sum(agg_counts[k] for k in ("gl_inv", "ext2_inv", "poseidon_gate_eval"))
    check(len(stats) == len(builds)
          and agg_counts["poseidon_gate_fill"] == agg_fills
          and agg_counts["ext2_reduce_chain"] == agg_chains
          and agg_counts["ext2_arith"] == agg_ariths
          and agg_counts[default] == len(agg_lanes)
          and all(agg_counts[k] > 0 for k in ("gl_inv", "ext2_inv", "poseidon_gate_eval"))
          and sum(agg_counts.values()) == (len(agg_lanes) + agg_fills + agg_chains
                                           + agg_ariths + agg_others),
          f"aggregation: launches {agg_counts} for {len(agg_lanes)} Poseidon calls "
          f"in the provers, {agg_fills} fill and {agg_chains} chain rows, {agg_ariths} "
          f"extension-arithmetic generators")
    check([st["degree_bits"] for st in stats] == [14, 14],
          f"aggregation: levels of degree 2^{[st['degree_bits'] for st in stats]}")
    check(SREC.verify_aggregated(agg, aset.merkle_root),
          "aggregation: verify_aggregated rejected the aggregate on the card")
    nulls = agg.nullifiers.copy()
    agg.nullifiers[2, 0] ^= np.uint64(1)
    check(not SREC.verify_aggregated(agg, aset.merkle_root),
          "aggregation: a flipped nullifier was accepted")
    agg.nullifiers = nulls
    first = aset.circuit()
    workers = aggregation_workers(cache[id(first.common)],
                                  [sig.proof for sig in signals[:RECURSION_SIGNALS]],
                                  first.vk, stats[0]["prove_s"])
    out["aggregation"] = {"signals": RECURSION_SIGNALS, "zero_knowledge": True,
                          "levels": stats, "seconds": agg_s,
                          "launches": agg_launches,
                          "field_launches": FIELD_PATH_LAUNCHES["aggregation"],
                          "ntt_launches": NTT_PATH_LAUNCHES["aggregation"],
                          "prover_poseidon_launches_by_lanes": {
                              n: agg_lanes.count(n) for n in sorted(set(agg_lanes))},
                          "public_inputs": int(agg.proof.public_inputs.shape[0]),
                          "workers": workers}

    # ---- (d) digest aggregation and the attestation
    t0 = time.perf_counter()
    res = SAGG.aggregate_signals_np(aset, signals[:RECURSION_SIGNALS])
    check(res["accept"] == [True] * RECURSION_SIGNALS and res["count"] == RECURSION_SIGNALS,
          f"aggregate_signals_np: {res['accept']}")
    # on the CPU the tree's permutation is the plain version
    cpu_digest_ = SAGG.aggregation_digest(aset, signals[:RECURSION_SIGNALS], res["accept"],
                                          device="cpu")
    check(np.array_equal(res["digest"], cpu_digest_),
          "aggregate_signals_np: the digest differs from the CPU tree's")
    att = SATT.make_attestation(aset, signals[:RECURSION_SIGNALS], oks=res["accept"])
    check(SATT.recheck_attestation(att, aset, signals[:RECURSION_SIGNALS]),
          "attestation: the recheck failed")
    changed = json.loads(att)
    changed["count"] -= 1
    check(not SATT.recheck_attestation(json.dumps(changed), aset,
                                       signals[:RECURSION_SIGNALS]),
          "attestation: a changed count passed the recheck")
    out["attestation"] = {"digest": [int(x) for x in res["digest"]], "bytes": len(att),
                          "seconds": time.perf_counter() - t0}

    # ---- the kernels' rows: the wrap's lane count, its launches
    fb, fo = fill_bound_ms(WRAP_BATCH)
    f16 = fill[WRAP_BATCH]
    rows["poseidon_gate_fill"] = kernel_row(
        "poseidon_gate_fill", f16["ms"], f16["plain_ms"], fb, fo, lanes=WRAP_BATCH,
        by_lanes=fill, launches_per_aggregation=agg_launches["poseidon_gate_fill"])
    rows["poseidon_gate_fill"]["launches"] = counts["poseidon_gate_fill"]
    k = REDUCING_STEPS
    cb, co = chain_bound_ms(WRAP_BATCH, k)
    c16 = chain[f"{WRAP_BATCH}x{k}"]
    rows["ext2_reduce_chain"] = kernel_row(
        "ext2_reduce_chain", c16["ms"], c16["plain_ms"], cb, co, lanes=WRAP_BATCH,
        steps=k, by_lanes_and_steps=chain,
        launches_per_aggregation=agg_launches["ext2_reduce_chain"])
    rows["ext2_reduce_chain"]["launches"] = counts["ext2_reduce_chain"]
    # the three later kernels: the wrap's lane counts (16 for the witness,
    # 16 x 2^16 points for the quotient), its launches; the other paths'
    # launches beside them
    # (None where this run did not drive that path: --only)
    others = {name: {"launches_per_aggregation": agg_launches[name],
                     "launches_per_prove": PATH_LAUNCHES["prove"][name]
                     if "prove" in PATH_LAUNCHES else None,
                     "launches_per_zk20_batch": PATH_LAUNCHES["zk20_batch"].get(name, 0)
                     if "zk20_batch" in PATH_LAUNCHES else None}
              for name in ("ext2_arith", "gl_inv", "ext2_inv", "poseidon_gate_eval")}
    for name, by_lanes, lanes in (("ext2_arith", arith, WRAP_BATCH),
                                  ("gl_inv", gl_inv, WRAP_BATCH),
                                  ("ext2_inv", ext2_inv, WRAP_BATCH),
                                  ("poseidon_gate_eval", evals, f"{WRAP_BATCH}x{1 << 16}")):
        at = by_lanes[lanes]
        larger = {k: at[k] for k in ("critical_path", "larger_bound_ms",
                                     "share_of_larger_bound", "larger_bound_by") if k in at}
        rows[name] = kernel_row(name, at["ms"], at["plain_ms"], at["bound_bytes_ms"],
                                at["bound_operations_ms"], lanes=lanes, by_lanes=by_lanes,
                                **others[name], **larger)
        rows[name]["launches"] = counts[name]
    emit({"phase": "recursion", **out,
          **{name: rows[name] for name in WK.KERNELS}})


PHASES = ("field_kernels", "poseidon_kernels", "probes", "main_path", "per_proof", "bridge_kernel",
          "wrapped", "compiled", "sharded", "ntt", "codec", "prove", "recursion")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on the GPU only",
              file=sys.stderr)
        sys.exit(1)
    only = None
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        only = sys.argv[2].split(",")
        check(set(only) <= set(PHASES), f"unknown phase in {only}; phases: {PHASES}")
    elif len(sys.argv) > 1:
        fail(f"usage: {sys.argv[0]} [--only PHASE[,PHASE...]]")
    device = torch.device("cuda")
    t_start = time.time()
    name, smi_line = phase_device()
    rows, seconds = {}, {}
    args = {"build": (device,), "per_proof": (device,), "sharded": (device,),
            "codec": (device,), "prove": (device,)}
    for phase in ("build",) + PHASES:
        if only is not None and phase not in only + ["build"]:
            continue
        t0 = time.time()
        globals()["phase_" + phase](*args.get(phase, (device, rows)))
        seconds[phase] = round(time.time() - t0, 1)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    emit({"phase": "seconds", "by_phase": seconds,
          "total": round(time.time() - t_start, 1)})
    if only is not None:
        print(smi_line, flush=True)
        emit({"partial": only})
        return
    # the field kernels' rows: a zk20 batch's launches (the main path);
    # gl_mul_add, which the verifier's extension ring never calls, the
    # counted prove's (its path); every path's beside them
    for fname in FK.KERNELS:
        path = "prove" if fname == "gl_mul_add" else "zk20_batch"
        rows[fname].update(launches=FIELD_PATH_LAUNCHES[path][fname], launches_path=path)
    # the NTT kernels' rows: a prove's launches (the wrap's where the
    # 64-signal prove's transforms all fit one tile); every path's beside them
    for kname in NK.KERNELS:
        path = "prove" if NTT_PATH_LAUNCHES["prove"][kname] else "wrap"
        rows[kname].update(launches=NTT_PATH_LAUNCHES[path][kname], launches_path=path,
                           launches_by_path={p: c[kname] for p, c in NTT_PATH_LAUNCHES.items()})
    check(all(rows[n]["launches"] > 0 for n in KERNEL_FILES),
          f"a kernel no path launched: {[n for n in KERNEL_FILES if not rows[n]['launches']]}")
    emit({"phase": "field_launches_by_path", **FIELD_PATH_LAUNCHES})
    emit({"phase": "ntt_launches_by_path", **NTT_PATH_LAUNCHES})
    keys = ("name", "route", "source", "replaces", "addition", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launch_floor_ms", "least_by")
    print(smi_line, flush=True)
    emit({"kernels": [{k: rows[n][k] for k in keys} for n in KERNEL_FILES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
