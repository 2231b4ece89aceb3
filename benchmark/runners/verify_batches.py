"""Batches of proofs verified by the port's compiled batch verifier: one
client, one batch in flight.

Set-up (timed from the process's start to the first timed batch): the
fixture read and checked, the pool of batches drawn from the seed
(harness/traffic.py), then the system under test: the port's
`make_verifier_fn_batched(common, vk)` gives `to_device`, and
`compiled_verifier(common, vk, pa, mode="batched")` warms the verifier
with one eager call and captures it in a CUDA graph; one whole batch
warms the loop. A batch in the window is four steps: the pool's u64
arrays on the host, `to_device`, the compiled verifier, its bool[B]
accept bits read back to the host.

With `trace`, each step sits in a span (`copy_in` and `replay` end in a
synchronise), and after the window a stretch of batches runs under the
profiler (harness/trace.py); the per-layer metrics (metrics/) read both.

After the window the program's state is freed and the plain reference
(reference/) verifies each distinct lane of the pool once; every lane of
every batch answered is compared with it (harness/judge.py).
"""
from __future__ import annotations

import ctypes
import importlib
import math
import pkgutil
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark import metrics as metric_pkg
from benchmark.harness import files, judge, window
from benchmark.harness import traffic as traffic_gen
from benchmark.harness.trace import Trace
from benchmark.reference.types import load_fixture
from benchmark.reference.verify import verify_lanes

# what the fixture's circuit data must state for each key of a configuration
CIRCUIT_KEYS = {
    "degree_bits": lambda c: c.fri_params.degree_bits,
    "num_wires": lambda c: c.config.num_wires,
    "hasher": lambda c: c.config.hasher,
    "zero_knowledge": lambda c: c.config.zero_knowledge,
    "rate_bits": lambda c: c.config.fri_config.rate_bits,
    "cap_height": lambda c: c.config.fri_config.cap_height,
    "num_query_rounds": lambda c: c.config.fri_config.num_query_rounds,
    "proof_of_work_bits": lambda c: c.config.fri_config.proof_of_work_bits,
}


def log(*parts):
    print("bench:", *parts, file=sys.stderr, flush=True)


class PortVerifier:
    """The system under test: the port's batch verifier, compiled for the
    shapes of `first` (a pool batch) on `device`."""

    def __init__(self, fixture, first: dict, device):
        from stark_verifier_tpu_torch.core.types import load_proofs
        from stark_verifier_tpu_torch.models import flagship

        _, common, vk = load_proofs(fixture)
        _, self.to_device = flagship.make_verifier_fn_batched(common, vk, device=device)
        self.comp = flagship.compiled_verifier(common, vk, self.to_device(first),
                                               mode="batched", device=device)

    def copy_in(self, batch: dict):
        return self.to_device(batch)

    def verify(self, pa):
        return self.comp(pa)

    def readback(self, bits):
        return bits.cpu().numpy()

    def graph_nodes(self):
        """The captured graph's node count: libcuda's cuGraphGetNodes."""
        n = ctypes.c_size_t(0)
        err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
            ctypes.c_void_p(self.comp.graph.raw_cuda_graph()), None, ctypes.byref(n))
        return n.value if err == 0 else None


@dataclass
class Run:
    """What a traced run gives the per-layer metrics to read."""
    config: dict
    batch: int
    copy_in_ms: list = field(default_factory=list)
    replay_ms: list = field(default_factory=list)
    batch_ms: list = field(default_factory=list)    # the window's latencies
    graph_nodes: int | None = None
    trace: Trace | None = None
    per_proof: dict = field(default_factory=dict)   # permutations a proof, by hasher


def check_circuit(config: dict, common):
    for key, get in CIRCUIT_KEYS.items():
        if key in config and get(common) != config[key]:
            raise files.FixtureChanged(f"{config['name']}: the fixture's {key} is "
                                       f"{get(common)!r}, the configuration states "
                                       f"{config[key]!r}")


def load_inputs(config: dict):
    """(arrays, common, vk, unsound arrays or None): the configuration's
    fixture and, where it names them, its unsound proofs, each checked
    against its sha256, the circuit against the configuration, and the
    unsound proofs' circuit against the fixture's."""
    arrays, common, vk = load_fixture(files.fixture_path(config))
    check_circuit(config, common)
    if "unsound_fixture" not in config:
        return arrays, common, vk, None
    unsound, _, uvk = load_fixture(files.fixture_path(config, prefix="unsound_"))
    if not (np.array_equal(uvk.constants_sigmas_cap, vk.constants_sigmas_cap)
            and np.array_equal(uvk.circuit_digest, vk.circuit_digest)):
        raise files.FixtureChanged(f"{config['name']}: the unsound proofs' circuit is "
                                   f"not the fixture's")
    return arrays, common, vk, unsound


def per_layer(run: Run) -> dict:
    """Every metric module's reading, the silent ones left out."""
    out = {}
    for mod in pkgutil.iter_modules(metric_pkg.__path__):
        m = importlib.import_module(f"{metric_pkg.__name__}.{mod.name}")
        value = m.read(run)
        if value is not None:
            out[mod.name] = {"value": value, "unit": m.UNIT}
    return out


def _sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, t0: float, program=PortVerifier,
        device="cuda", reference=verify_lanes):
    """One run of `cell`; returns (result dict without `checks`, checks,
    the batch times' summary line)."""
    import torch

    device = torch.device(device)
    config, mix = cell.config, cell.traffic
    if mix.get("closed_loop_clients", 1) != 1:
        raise ValueError(f"{mix['name']}: this runner runs one closed-loop client")
    arrays, common, vk, unsound = load_inputs(config)
    fixture = files.ROOT / config["fixture"]      # its sha256 checked just above
    pool = traffic_gen.make_pool(arrays, config, mix, seed, unsound)
    B, P = pool.batch, len(pool.batches)
    n_unsound = sum(1 for v in pool.variants if v[2] is None)
    log(f"{cell.name}: B = {B}, pool {P} batches, {len(pool.variants)} lanes corrupted, "
        f"{n_unsound} of them unsound, seed {seed}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prog = program(fixture, pool.batches[0], device)
    meta = Run(config=config, batch=B)

    def step(j, span=None):
        if span is None:
            return prog.readback(prog.verify(prog.copy_in(pool.batches[j])))
        with span("copy_in"):
            c0 = time.perf_counter()
            pa = prog.copy_in(pool.batches[j])
            _sync(device)
            meta.copy_in_ms.append((time.perf_counter() - c0) * 1e3)
        with span("replay"):
            c0 = time.perf_counter()
            bits = prog.verify(pa)
            _sync(device)
            meta.replay_ms.append((time.perf_counter() - c0) * 1e3)
        with span("readback"):
            return prog.readback(bits)

    from contextlib import nullcontext

    spans = (lambda name: nullcontext()) if trace else None
    step(0, spans)
    meta.copy_in_ms.clear()
    meta.replay_ms.clear()
    setup_s = time.perf_counter() - t0
    w = window.run_window(lambda j: step(j, spans), P, seconds, first=1)
    answers = list(zip(w.pool_index, w.outputs))
    lat = meta.batch_ms = w.latencies_ms
    summary = (f"batch_ms: median {window.quantile(lat, 0.5):.4f}, p90 "
               f"{window.quantile(lat, 0.9):.4f}, over {w.batches} batches of {B} in "
               f"{w.seconds:.3f} s; setup_s {setup_s:.3f}")
    log(summary)
    if trace:
        log(f"spans: copy_in median {window.quantile(meta.copy_in_ms, 0.5):.4f} ms, replay "
            f"median {window.quantile(meta.replay_ms, 0.5):.4f} ms")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips}
    if trace:
        n = min(10, max(3, math.ceil(1.0 / (window.quantile(lat, 0.5) * 1e-3))))
        first = (w.pool_index[-1] + 1) % P
        traced = []

        def traced_step(k, span):
            j = (first + k) % P
            traced.append((j, step(j, span)))

        meta.trace = Trace()
        meta.trace.record(traced_step, n)
        answers += traced
        meta.graph_nodes = prog.graph_nodes() if hasattr(prog, "graph_nodes") else None
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    del prog, step
    if device.type == "cuda":
        torch.cuda.empty_cache()

    r0 = time.perf_counter()
    ref_bits, meta.per_proof = reference(common, vk, pool.ref_arrays, device)
    log(f"reference: {len(ref_bits)} distinct lanes in {time.perf_counter() - r0:.3f} s; "
        f"permutations a proof {meta.per_proof}")
    judge.check_reference(ref_bits, pool.n_honest)
    verdict = judge.compare(answers, pool.ref_lane, ref_bits)
    checks = verdict["checks"]
    failed = checks["mismatched_lanes"]["value"]
    result = {"correct": judge.passed(checks), "attempted": verdict["attempted"],
              "failed": failed}
    if trace:
        result["metrics"] = per_layer(meta)
        dev["busy_s"] = meta.trace.busy_s
        dev["window_s"] = meta.trace.window_s
        result["device"] = dev
        result["breakdown"] = {"device_ops": meta.trace.top_ops(10),
                               "idle_gaps": meta.trace.idle_by_span()[:10]}
    else:
        result["metrics"] = {
            "verified_proofs_per_s": {"value": window.rate(B, w), "unit": "proofs/s"},
            "batch_ms_p90": {"value": window.quantile(lat, 0.9), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        result["device"] = dev
    return result, checks, summary
