#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA card (built for Hopper, sm_90a), `nvcc`, and no network. It

  1. names the device;
  2. builds every hand-written kernel from the sources in this checkout;
  3. holds each kernel against its plain PyTorch version on the card, at the
     lane counts the main path gives it (exact equality: this is modular
     arithmetic), and times both;
  4. drives the main path: 64 distinct zero-knowledge Semaphore proofs
     (2^20-member set, 135 wires, 28 FRI queries) tiled to a batch of 1024,
     through load_proofs -> batched_arrays -> make_verifier_fn_batched on
     the card; checks that all are accepted, that corrupted lanes and only
     those are rejected, that the kernel's launch count equals the number of
     permutation calls the path makes, and that challenges and accept bits
     equal the same path run with the plain permutation on the card and on
     the CPU;
  5. prints one JSON line per phase, the kernels' line, and as the last line
     {"ok": true, "device": {...}}.

Any failure ends the run with a non-zero exit code and no "ok" line. There
is no fallback: without a card, without nvcc, or with a kernel that does
not build, launch or agree, the script fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from stark_verifier_tpu_torch.core import verifier as V
from stark_verifier_tpu_torch.core import verifier_batched as VB
from stark_verifier_tpu_torch.core.types import load_proofs
from stark_verifier_tpu_torch.models import flagship as FS
from stark_verifier_tpu_torch.ops import cuda_build, gl64
from stark_verifier_tpu_torch.ops import poseidon_gl as pg
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "fixtures" / "sem_zk20b64.npz"
BATCH = 1024
SEED = 20

# Published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of device
# memory; 67 TFLOP/s float32 outside the tensor cores = 33.5e12 fused
# multiply-adds a second on 128 lanes per SM. The 32-bit integer pipe has 64
# lanes per SM, so it issues half as many instructions: 16.75e12 a second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_INSTR_PER_S = 67e12 / 2 / 2

# 32-bit integer instructions the permutation needs at the least, by count
# of the algorithm (csrc/poseidon_gl.cu), one lane:
#   field multiply: a 64x64->128 product is 4 wide 32x32 multiplies and 4
#     carry adds; the Goldilocks fold is 12 add/compare/select -> 20;
#   s-boxes: 4 multiplies each, 12 lanes in 8 full rounds + 1 lane in 22
#     partial rounds -> 472 multiplies;
#   round-constant add on any representative: 9, for 30 * 12 words;
#   MDS layer: 2 * (144 + 1) wide multiply-adds + 12 recombine-and-fold of
#     about 10 -> 410, for 30 layers.
INT32_INSTR_PER_PERMUTATION = 472 * 20 + 360 * 9 + 30 * 410
BYTES_PER_PERMUTATION = 2 * 12 * 8

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


def phase_build():
    t0 = time.time()
    logs = cuda_build.build_all()
    pk._library()  # load, bind, upload the constants
    seconds = time.time() - t0
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "sources": sorted(cuda_build.SOURCES.values()),
          "nvcc": cuda_build.nvcc_path(), "flags": cuda_build.NVCC_FLAGS,
          "seconds": round(seconds, 2), "ptxas": ptxas})


def phase_kernels(device):
    """poseidon_permute against permute_plain on the card."""
    rng = np.random.default_rng(SEED)
    worst = 0
    lane_counts = [1, 8, 1024, 28 * BATCH, 4 * 28 * BATCH]
    for lanes in lane_counts:
        x = gl64.from_u64(edge_state(rng, lanes), device)
        got = pk.permute(x)
        torch.cuda.synchronize()
        want = pk.permute_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            a = got.cpu().numpy().view(np.uint64).astype(object)
            b = want.cpu().numpy().view(np.uint64).astype(object)
            worst = max(worst, int(np.abs(a - b).max()))
            fail(f"poseidon_permute != permute_plain at {lanes} lanes "
                 f"(max abs difference {worst})")
        # a trailing shape other than flat must give the same words
        if lanes == 28 * BATCH:
            got2 = pk.permute(x.reshape(12, BATCH, 28))
            check(torch.equal(got2.reshape(12, -1), want),
                  "poseidon_permute differs on a [12, B, Q] state")
    lanes = lane_counts[-1]
    x = gl64.from_u64(edge_state(rng, lanes), device)
    for _ in range(3):
        pk.permute(x)
    ms = cuda_ms(lambda: pk.permute(x), 50)
    pk.permute_plain(x)
    plain_ms = cuda_ms(lambda: pk.permute_plain(x), 3)
    t_bytes = lanes * BYTES_PER_PERMUTATION / PEAK_BYTES_PER_S * 1e3
    t_ops = lanes * INT32_INSTR_PER_PERMUTATION / PEAK_INT32_INSTR_PER_S * 1e3
    row = {
        "name": "poseidon_permute", "route": "cuda",
        "source": "stark_verifier_tpu_torch/ops/csrc/poseidon_gl.cu",
        "replaces": "stark_verifier_tpu/ops/pallas/poseidon_kernel.py:331",
        "launches": None, "max_abs_err": float(worst),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no PyTorch call computes this function
        "lanes": lanes, "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
        "permutations_per_s": lanes / (ms * 1e-3),
    }
    emit({"phase": "kernels", "lane_counts": lane_counts, "equal": True,
          "poseidon_permute": row})
    return row


def challenges_u64(F, common, digest, pa, perm):
    """Public-input hash and every Fiat-Shamir challenge as uint64 numpy."""
    B = pa["public_inputs"].shape[0]
    pi_hash = pg.hash_no_pad(F, V._scalar_list(F, pa["public_inputs"]),
                             shape=(B,), permute=perm)
    ch = VB._get_challenges_batched(F, common, pa, pi_hash, digest, B, perm)
    flat = list(pi_hash)
    for name in ("plonk_betas", "plonk_gammas", "plonk_alphas",
                 "fri_query_indices"):
        flat += getattr(ch, name)
    flat += [*ch.plonk_zeta, *ch.fri_alpha, ch.fri_pow_response]
    for b in ch.fri_betas:
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


def phase_main_path(device, kernel_row):
    proofs, common, vk = load_proofs(FIXTURE)
    distinct = len(proofs)
    cfg = common.config.fri_config
    check(common.config.num_wires == 135 and cfg.num_query_rounds == 28
          and common.degree_bits == 9 and common.fri_params.hiding,
          "the fixture is not the zk20 circuit")
    while len(proofs) < BATCH:
        proofs = proofs + proofs
    proofs = proofs[:BATCH]
    batched = FS.batched_arrays(proofs)

    fn, to_device = FS.make_verifier_fn_batched(common, vk)  # device="cuda"
    pa = to_device(batched)
    torch.cuda.synchronize()

    # ---- the main path, counted
    pk.LAUNCHES = 0
    ok = fn(pa)
    torch.cuda.synchronize()
    launches = pk.LAUNCHES
    check(ok.dtype == torch.bool and tuple(ok.shape) == (BATCH,),
          f"accept bits have shape {tuple(ok.shape)} and type {ok.dtype}")
    check(bool(ok.all()), f"{int((~ok).sum())} honest proofs were rejected")
    check(launches > 0, "the main path launched no poseidon_permute kernel")

    # ---- corrupted lanes, and only those, are rejected
    lanes = [3, BATCH // 10, BATCH // 2, BATCH * 7 // 10, BATCH - 24]
    ok_bad = fn(to_device(corrupt(batched, lanes)))
    expect = torch.ones(BATCH, dtype=torch.bool)
    expect[lanes] = False
    check(torch.equal(ok_bad.cpu(), expect),
          f"rejected lanes {torch.nonzero(~ok_bad.cpu()).flatten().tolist()}, "
          f"expected {lanes}")

    # ---- the path's permutation calls, counted apart from the wrapper's
    # count: a counting permutation handed to the same path at B = 64
    F = gl64.Field(device)
    digest = F.from_u64(vk.circuit_digest)
    small = {k: v[:64] for k, v in batched.items()}
    pa64 = to_device(small)
    calls = [0]

    def counting(F_, state):
        calls[0] += 1
        return pg.permute(F_, state)

    fn_count, _ = FS.make_verifier_fn_batched(common, vk, permute=counting)
    ok64 = fn_count(pa64)
    n_calls = calls[0]
    check(launches == n_calls,
          f"{launches} kernel launches for {n_calls} permutation calls")

    # ---- the same path with the plain permutation on the card, B = 64
    fn_plain, _ = FS.make_verifier_fn_batched(common, vk, permute=pg.permute_plain)
    before = pk.LAUNCHES
    ok64_plain = fn_plain(pa64)
    ch_plain = challenges_u64(F, common, digest, pa64, pg.permute_plain)
    check(pk.LAUNCHES == before, "the plain path launched the kernel")
    ch_kernel = challenges_u64(F, common, digest, pa64, pg.permute)
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

    # ---- steady state
    reps = 5
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = fn(pa)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check(bool(ok.all()), "a repetition rejected an honest proof")
    ms = float(np.median(times)) * 1e3
    kernel_row["launches"] = launches
    emit({"phase": "main_path", "fixture": FIXTURE.name, "distinct": distinct,
          "batch": BATCH, "wires": common.config.num_wires,
          "queries": cfg.num_query_rounds, "degree_bits": common.degree_bits,
          "zero_knowledge": common.fri_params.hiding,
          "fold_layers": len(common.fri_params.reduction_arity_bits),
          "accepted": int(ok.sum()), "rejected_lanes": lanes,
          "poseidon_permute_launches": launches, "permutation_calls": n_calls,
          "equal_to_plain_on_card": True, "equal_to_cpu": True,
          "ms_per_batch": ms, "ms_per_batch_all": [t * 1e3 for t in times],
          "proofs_per_s": BATCH / (ms * 1e-3),
          "peak_device_bytes": torch.cuda.max_memory_allocated()})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on the GPU only",
              file=sys.stderr)
        sys.exit(1)
    device = torch.device("cuda")
    name, smi_line = phase_device()
    phase_build()
    kernel_row = phase_kernels(device)
    phase_main_path(device, kernel_row)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi_line, flush=True)
    emit({"kernels": [{k: kernel_row[k] for k in keys}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
