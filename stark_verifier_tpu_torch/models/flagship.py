"""The flagship pipeline: Semaphore proofs proved and verified on the GPU.

Proves a batch of Semaphore signals over an access set on a device
(`build_semaphore_batch`; `build_dryrun_batch` proves the small multichip
dryrun circuit) or loads one from a fixture (core/types.load_proofs),
stacks the proofs along a leading batch axis, and exposes the verifier
over int64 tensors on a device: batch-in-lanes (`make_verifier_fn_batched`,
the unit of throughput) or proof by proof (`make_verifier_fn`, and
`make_verifier_fn_phased`, which runs the three protocol phases apart).
All three take the same batched dict and return the accept bits bool[B];
`compiled_verifier` captures the first two, for fixed shapes, in a CUDA
graph that later calls replay. chip_smoke.py drives them.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..core import verifier as V
from ..core import verifier_batched as VB
from ..core.merkle import MerkleTree
from ..core.types import CircuitConfig, FriConfig, load_proofs, save_proofs
from ..ops import gl64
from ..prover.builder import CircuitBuilder
from ..prover.builder import require_device as _require_device
from ..prover.prove import prove_batch
from ..semaphore.access_set import AccessSet

FIXTURE_DIR = Path(__file__).resolve().parent.parent.parent / "fixtures"


def small_config() -> CircuitConfig:
    """Small preset for smoke paths."""
    return CircuitConfig(
        fri_config=FriConfig(rate_bits=3, cap_height=1, proof_of_work_bits=8,
                             num_query_rounds=4)
    )


def bench_config() -> CircuitConfig:
    """The headline Semaphore FRI parameters (plonky2_semaphore's access
    set): blowup 8, 28 queries, 16 PoW bits, cap height 4."""
    return CircuitConfig(
        fri_config=FriConfig(rate_bits=3, cap_height=4, proof_of_work_bits=16,
                             num_query_rounds=28)
    )


def build_semaphore_batch(n_members_bits=8, batch=8, config=None, min_degree=0,
                          cache_tag=None, seed=0, device="cuda", cache_dir=None,
                          witness_rng=None, salt_rng=None):
    """(proofs, common, vk): `batch` Semaphore signals over one access set
    of 2^n_members_bits keys, proved on `device`. Keys, indices and topics
    come from `seed`, drawn as the JAX package draws them; the rngs are
    prove_batch's. With a `cache_tag` the proofs are read from, or written
    to, `cache_dir`/sem_<tag>.npz. With a `cache_tag` or a `cache_dir`, a
    set of 2^16 keys or more keeps its hashed keys and tree in
    `cache_dir`/aset_tree_<bits>_<seed>.npz; with neither, nothing is read
    or written. `cache_dir` defaults to the repo's fixtures/."""
    caching = bool(cache_tag) or cache_dir is not None
    cache_dir = Path(cache_dir) if cache_dir is not None else FIXTURE_DIR
    if cache_tag and (cache_dir / f"sem_{cache_tag}.npz").exists():
        return load_proofs(cache_dir / f"sem_{cache_tag}.npz")
    device = _require_device(device)
    rng = np.random.default_rng(seed)
    n = 1 << n_members_bits
    sks = rng.integers(0, gl64.P, size=(n, 4), dtype=np.uint64)
    config = config or small_config()
    tree_cache = (cache_dir / f"aset_tree_{n_members_bits}_{seed}.npz"
                  if caching and n_members_bits >= 16 else None)
    if tree_cache is not None and tree_cache.exists():
        aset = AccessSet.from_tree(MerkleTree.load(tree_cache, device), config,
                                   min_degree=min_degree)
    else:
        pks = AccessSet.public_key(gl64.from_u64(sks, device))
        aset = AccessSet(pks, config, min_degree=min_degree, device=device)
        if tree_cache is not None:
            cache_dir.mkdir(parents=True, exist_ok=True)
            aset.tree.save(tree_cache)
    idx = rng.integers(0, n, size=batch)
    topics = rng.integers(0, gl64.P, size=(batch, 4), dtype=np.uint64)
    signals = aset.make_signals(sks[idx], topics, idx, witness_rng=witness_rng,
                                salt_rng=salt_rng)
    proofs = [s.proof for s in signals]
    data = aset.circuit()
    if cache_tag:
        cache_dir.mkdir(parents=True, exist_ok=True)
        save_proofs(cache_dir / f"sem_{cache_tag}.npz", proofs, data.common, data.vk)
    return proofs, data.common, data.vk


def dryrun_config() -> CircuitConfig:
    """The multichip dryrun's config: 2 FRI queries, cap 0, 8 wires, and
    the public-input hash outside the gates, so no PoseidonGate."""
    return CircuitConfig(
        num_wires=8, num_routed_wires=8,
        fri_config=FriConfig(rate_bits=3, cap_height=0, proof_of_work_bits=4,
                             num_query_rounds=2),
        pi_hash_in_circuit=False,
    )


def build_dryrun_batch(batch=16, cache_tag="dryrun3w8", device="cuda",
                       cache_dir=None, witness_rng=None, salt_rng=None):
    """(proofs, common, vk): a tiny arithmetic circuit (Arithmetic,
    Constant, PublicInput and Noop gates) proved for `batch` lanes on
    `device`: the multichip dryrun's workload. Caching as in
    build_semaphore_batch."""
    cache_dir = Path(cache_dir) if cache_dir is not None else FIXTURE_DIR
    path = cache_dir / f"sem_{cache_tag}.npz" if cache_tag else None
    if path is not None and path.exists():
        proofs, common, vk = load_proofs(path)
        if len(proofs) >= batch:
            return proofs[:batch], common, vk
    b = CircuitBuilder(dryrun_config(), device=device)
    xs = b.add_virtual_targets(4)
    acc = b.mul(xs[0], xs[1])
    acc = b.arithmetic(3, 5, acc, xs[2], xs[3])
    b.register_public_inputs(xs)
    b.register_public_input(acc)
    data = b.build()
    rng = np.random.default_rng(7)
    inputs = {t: rng.integers(0, gl64.P, size=batch, dtype=np.uint64) for t in xs}
    proofs = prove_batch(data, inputs, batch, device=device,
                         witness_rng=witness_rng, salt_rng=salt_rng)
    if path is not None:
        cache_dir.mkdir(parents=True, exist_ok=True)
        save_proofs(path, proofs, data.common, data.vk)
    return proofs, data.common, data.vk


def batched_arrays(proofs) -> dict:
    """Stack per-proof arrays along a leading batch axis (u64 numpy)."""
    pas = [V.proof_to_arrays(p) for p in proofs]
    return {k: np.stack([pa[k] for pa in pas]) for k in pas[0]}


def _bind(common, vk, device):
    """(F, vk_cap, digest, to_device) on `device`: what every entry point
    below closes over."""
    F = gl64.Field(_require_device(device))
    vk_cap = F.from_u64(vk.constants_sigmas_cap)
    digest = F.from_u64(vk.circuit_digest)

    def to_device(batched):
        return {k: F.from_u64(v) for k, v in batched.items()}

    return F, vk_cap, digest, to_device


def _one_by_one(verify_one):
    """Lift a per-proof verifier to the batched dict: proof b is the b-th
    slice of every array; the accept bits are stacked to bool[B]."""
    def fn(pa):
        n = pa["public_inputs"].shape[0]
        return torch.stack(
            [verify_one({k: v[b] for k, v in pa.items()}) for b in range(n)])

    return fn


def make_verifier_fn(common, vk, device="cuda", permute=None,
                     inner_permute=None):
    """Per-proof verifier (core/verifier.verify) on `device`, proofs verified
    one by one: where the JAX package maps its single-proof verifier over
    the batch, this loops. Returns (fn, to_device) as
    make_verifier_fn_batched does. A proof's Poseidon calls have 1, Q and
    4 * Q lanes (Q = number of FRI queries)."""
    F, vk_cap, digest, to_device = _bind(common, vk, device)
    return _one_by_one(
        lambda pa: V.verify(F, common, vk_cap, digest, pa, permute=permute,
                            inner_permute=inner_permute)
    ), to_device


def make_verifier_fn_phased(common, vk, device="cuda", permute=None,
                            inner_permute=None):
    """The per-proof verifier as its three phases (challenges, vanishing
    polynomial, FRI) run in sequence; the challenges cross the phase
    boundaries as a plain dict. Same result as make_verifier_fn."""
    F, vk_cap, digest, to_device = _bind(common, vk, device)

    def verify_one(pa):
        pi_hash, ch = V.phase_challenges(F, common, digest, pa, permute=permute,
                                         inner_permute=inner_permute)
        ok = V.phase_vanishing(F, common, pa, pi_hash, ch)
        return V.phase_fri(F, common, vk_cap, pa, ch, ok, permute=permute)

    return _one_by_one(verify_one), to_device


def make_verifier_fn_batched(common, vk, device="cuda", permute=None,
                             inner_permute=None):
    """Batch-in-lanes verifier (core/verifier_batched.py) on `device`.

    Returns (fn, to_device): `to_device` maps the u64 numpy dict of
    `batched_arrays` to int64 tensors on the device, `fn` maps those to the
    accept bits bool[B]. `permute` overrides the transcript and Merkle
    permutation, `inner_permute` the public-input hash's (see
    core/verifier.py), e.g. `functools.partial(poseidon_gl.permute, mxu=1)`
    for a kernel variant. By default the transcript follows the circuit's
    hash config (Goldilocks Poseidon, or the BN254 bridge under "bn254"),
    the public-input hash is Goldilocks Poseidon, and on a CUDA device each
    launches its Hopper kernel (SVT_POSEIDON_MXU names the Poseidon one)."""
    F, vk_cap, digest, to_device = _bind(common, vk, device)

    def fn(pa):
        return VB.verify_batched(F, common, vk_cap, digest, pa, permute=permute,
                                 inner_permute=inner_permute)

    return fn, to_device


# ------------------------------------------------------- the compiled form
class CompiledVerifier:
    """A verifier function fixed to the keys, shapes, dtypes and device of
    one batched dict, as an XLA executable is fixed to its input shapes.

    On a CUDA device one call of `fn` is captured in a `torch.cuda.CUDAGraph`
    reading static input buffers (clones of the dict it was built from),
    after one warm-up call on a side stream that loads the kernel libraries
    and uploads every constant table (gl64.table, cuda_build.library_on); a
    call copies its argument into the buffers, replays the graph and returns
    a copy of the accept bits, which the next replay overwrites. A capture
    that fails raises: nothing falls back to the eager function. On the CPU
    the same buffers and copies feed the eager function. `capture_s` and
    `instantiate_s` are the seconds the two steps took (on the CPU, 0)."""

    def __init__(self, fn, pa: dict, device):
        self.device = _require_device(device)
        self._fn = fn
        self._spec = {k: (tuple(v.shape), v.dtype) for k, v in pa.items()}
        self._check(pa)
        self._static = {k: v.clone() for k, v in pa.items()}
        self.graph, self.capture_s, self.instantiate_s = None, 0.0, 0.0
        if self.device.type == "cuda":
            self._capture()

    def _capture(self):
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._fn(self._static)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            # keep_graph: instantiated apart from the capture, timed apart,
            # and its nodes readable (graph.raw_cuda_graph())
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.perf_counter()
            with torch.cuda.graph(graph):
                self._out = self._fn(self._static)
            t1 = time.perf_counter()
            graph.instantiate()
            torch.cuda.synchronize()
            self.capture_s, self.instantiate_s = t1 - t0, time.perf_counter() - t1
            self.graph = graph

    def _check(self, pa: dict):
        if set(pa) != set(self._spec):
            raise ValueError(f"compiled for keys {sorted(self._spec)}, called with "
                             f"{sorted(pa)}")
        for k, v in pa.items():
            shape, dtype = self._spec[k]
            if not torch.is_tensor(v) or tuple(v.shape) != shape or v.dtype != dtype:
                got = (tuple(v.shape), v.dtype) if torch.is_tensor(v) else type(v)
                raise ValueError(f"{k}: compiled for {shape} {dtype}, called with {got}")
            if torch.device(v.device) != self.device:
                raise ValueError(f"{k}: compiled for {self.device}, called with {v.device}")

    def __call__(self, pa: dict) -> torch.Tensor:
        self._check(pa)
        for k, v in pa.items():
            self._static[k].copy_(v)
        if self.graph is None:
            return self._fn(self._static)
        with torch.cuda.device(self.device):
            self.graph.replay()
            return self._out.clone()


def compiled_verifier(common, vk, pa: dict, cache_path=None, mode="vmap",
                      device="cuda", permute=None, inner_permute=None):
    """The verifier compiled for the shapes of `pa` (the dict `to_device`
    returns), the counterpart of the JAX package's AOT-compiled verifier:
    `mode="batched"` captures make_verifier_fn_batched's function, "vmap"
    make_verifier_fn's (proof by proof), both as a CompiledVerifier;
    "phased" returns make_verifier_fn_phased's function uncompiled, as the
    JAX package does. `permute` and `inner_permute` are the makers'. A
    call with other keys, shapes, dtypes or device raises ValueError.

    PyTorch has no serialised form of a CUDA graph, so there is no
    executable to cache: a `cache_path` raises NotImplementedError. What a
    later process reuses is the kernels' build directory (ops/cuda_build)."""
    if cache_path is not None:
        raise NotImplementedError(
            "compiled_verifier: a CUDA graph has no serialised form to save or "
            "load; capture it again in each process (the kernels' builds are "
            "reused from ops/cuda_build's directory)")
    makers = {"batched": make_verifier_fn_batched, "vmap": make_verifier_fn,
              "phased": make_verifier_fn_phased}
    if mode not in makers:
        raise ValueError(f"compiled_verifier: mode {mode!r}, not one of {sorted(makers)}")
    fn, _ = makers[mode](common, vk, device=device, permute=permute,
                         inner_permute=inner_permute)
    if mode == "phased":
        return fn
    return CompiledVerifier(fn, pa, device)
