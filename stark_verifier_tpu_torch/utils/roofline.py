"""Field-arithmetic rates of the device: sustained Goldilocks multiplies/s
through ops/gl64.py's mul, and Poseidon permutations/s of each
hand-written kernel variant.

    python3 -m stark_verifier_tpu_torch.utils.roofline

needs a CUDA device. A Goldilocks multiply of ops/gl64.py on a card is
one launch of csrc/field.cu's gl_mul over 8-byte words, so that rate is
bound by bytes (and at small batches by the launch); a permutation kernel
keeps its state in registers and is bound by integer operations (see
ops/poseidon_kernel.py).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import gl64
from ..ops import poseidon_kernel as pk


def _seconds(fn, reps, device):
    """Mean seconds of `fn` over `reps` calls after one warm-up: CUDA events
    on a card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3 / reps


def graph_ms(fn, reps, replays=3):
    """Device time of one call of `fn` on the card, in ms: `reps` calls
    captured in a CUDA graph and replayed, so that no host work stands
    between the launches (a narrow kernel finishes before the host has
    issued the next eager call); the least of `replays` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = None
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        t = start.elapsed_time(end) / reps
        best = t if best is None else min(best, t)
    del graph
    return best


def measure(batch=1 << 16, iters=64, reps=5, device="cuda"):
    """Rates at `batch` elements (lanes): a chain of `iters` dependent
    multiplies, and one permutation a variant. The result names the device
    it was taken on; without a card `device="cuda"` raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("roofline.measure: no CUDA device; pass device='cpu' "
                           "to time the plain PyTorch path on the host")
    rng = np.random.default_rng(0)
    a = gl64.from_u64(rng.integers(0, gl64.P, batch, dtype=np.uint64), device)
    b = gl64.from_u64(rng.integers(0, gl64.P, batch, dtype=np.uint64), device)

    def mul_chain():
        x = a
        for _ in range(iters):
            x = gl64.mul(x, b)
        return x

    muls_per_s = batch * iters / _seconds(mul_chain, reps, device)
    state = gl64.from_u64(
        rng.integers(0, gl64.P, (12, batch), dtype=np.uint64), device)
    # on a CPU tensor the wrapper runs the plain version: name it so
    names = pk.KERNELS if device.type == "cuda" else tuple(
        f"permute_plain_mxu{mxu}" for mxu in (0, 1, 2))
    perms_per_s = {
        names[mxu]: batch / _seconds(lambda: pk.permute(state, mxu), reps, device)
        for mxu in (0, 1, 2)}
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {
        "device": name,
        "batch": batch,
        "gl_mul_per_s": muls_per_s,
        "poseidon_perm_per_s": perms_per_s,
    }


if __name__ == "__main__":
    import json

    print(json.dumps(measure(), indent=1))
