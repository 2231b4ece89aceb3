#!/usr/bin/env python3
"""The NTT kernels (`ntt_tile`, `ntt_stride`, ops/csrc/ntt.cu) against the
tile sizes and the load that the kept design turned down, on one GPU.

    python3 tools/torch_ntt_alternatives.py [--reps 20] [--out FILE]

Runs each transform through ops/ntt.py's functions on CUDA tensors, as:

  kept    the package: tiles of 2^12 (ntt_kernel.TILE_BITS), and an LDE's
          stages that only pair words with 0 made as copies at ntt_tile's
          load;
  t11     tiles of 2^11: a second launch from 2^12 output points up;
  t13     tiles of 2^13: one 64 KB tile a block;
  nocopy  tiles of 2^12 from ntt.cu built with no copied stages: every
          stage's butterflies run, a zero-padded LDE's first r on zeros.

Every alternative is held word for word against the kept design at every
transform shape chip_smoke.py times (its NTT_TIMED: the widest LDE, the
64-signal prove's, a wrap's and an aggregation level's), then timed in
turns (the order, then the reverse; the smaller of the two kept) as device
time of the transform from a CUDA graph, beside the transform's bound
(chip_smoke.ntt_bound_ms). One JSON line a shape, each also written to
FILE with --out. Needs a CUDA device and nvcc; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from stark_verifier_tpu_torch.ops import cuda_build, ntt  # noqa: E402
from stark_verifier_tpu_torch.ops import ntt_kernel as NK  # noqa: E402
from stark_verifier_tpu_torch.utils.roofline import graph_ms  # noqa: E402

# ntt_tile's count of copied stages; without it `copies` stays 0
COPY_LOOP = "    while (copies < tb && (n_in << (copies + 1)) <= (1ll << bits)) ++copies;\n"
OUT: list = []                          # the --out file, when given


def emit(obj):
    """One JSON line, on stdout and appended to the --out file."""
    line = json.dumps(obj)
    print(line, flush=True)
    for path in OUT:
        with path.open("a") as f:
            f.write(line + "\n")


def build_nocopy():
    """ntt.cu without its copied stages, built with the package's flags
    into build/ and bound as the package binds its library."""
    src = (cuda_build.CSRC / cuda_build.SOURCES["ntt"]).read_text()
    if src.count(COPY_LOOP) != 1:
        sys.exit("ntt.cu is not as this script expects")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = cuda_build.BUILD_DIR / "ntt_alt_nocopy.cu"
    target.write_text(src.replace(COPY_LOOP, ""))
    lib_path = target.with_suffix(".so")
    cmd = [cuda_build.nvcc_path(), *cuda_build._flags("ntt"), "-I", str(cuda_build.CSRC),
           "-o", str(lib_path), str(target)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"nvcc failed for nocopy:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    NK._bind(lib)
    return lib


def as_built(device, lib, tile_bits, fn):
    """fn run with `lib` as the device's NTT library and tiles of
    2^tile_bits, the package's own restored after."""
    def run():
        saved = NK._libs[device.index], NK.TILE_BITS
        NK._libs[device.index], NK.TILE_BITS = lib, tile_bits
        try:
            return fn()
        finally:
            NK._libs[device.index], NK.TILE_BITS = saved
    return run


def in_turns(runs, reps):
    """Device ms of each run, in the order and the reverse; the smaller."""
    ms = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        ms[name].append(graph_ms(runs[name], reps))
    return {name: min(t) for name, t in ms.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_ntt_alternatives: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("")
        OUT.append(args.out)
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()})
    device = torch.device("cuda", torch.cuda.current_device())
    kept = NK._library(device)
    nocopy = build_nocopy()
    designs = {"kept": (kept, NK.TILE_BITS), "t11": (kept, 11), "t13": (kept, 13),
               "nocopy": (nocopy, NK.TILE_BITS)}
    rng = np.random.default_rng(CS.SEED + 5)
    for label, name, rows, bits, fargs in CS.NTT_TIMED:
        x = CS.ntt_words(rng, (rows, 1 << bits), device)
        fn = getattr(ntt, name)
        want = fn(x, *fargs)
        n_out = want.shape[-1]
        out_bits = n_out.bit_length() - 1
        runs = {}
        for design, (lib, t) in designs.items():
            if out_bits > 2 * t:
                continue
            run = as_built(device, lib, t, lambda: fn(x, *fargs))
            if not torch.equal(run(), want):
                sys.exit(f"{design} differs from the kept design at {label}")
            runs[design] = run
        reps = 5 if rows * n_out >= 1 << 24 else args.reps
        ms = in_turns(runs, reps)
        t_bytes, t_ops = CS.ntt_bound_ms(name, rows, 1 << bits, n_out)
        emit({"call": label, "function": name, "rows": rows, "points_in": 1 << bits,
              "points_out": n_out, "equal_to_kept": True, "ms": ms,
              "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
              "share_of_bound": {d: max(t_bytes, t_ops) / v for d, v in ms.items()},
              "launches": {d: 1 + (out_bits > t) for d, (_, t) in designs.items()
                           if d in ms}})
        del x, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
