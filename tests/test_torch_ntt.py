"""The port's NTT (ops/ntt.py on int64 tensors, ops/ntt_np.py its numpy
oracle) against the JAX package's numpy NTT (ops/ntt_np.py) and its JAX
NTT (ops/ntt_jax.py, n <= 64) on the CPU: ntt, intt, coset_fft and
coset_lde (rate 2 and 3, shift 7) over batch shapes, with the inputs 0 and
p - 1; ntt_4step on one rank in this process and on gloo worlds of 2 and 4
processes. Exact equality throughout."""
import datetime
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stark_verifier_tpu.ops import gl64_jax as gj
from stark_verifier_tpu.ops import ntt_jax as rj
from stark_verifier_tpu.ops import ntt_np as rn
from stark_verifier_tpu_torch.ops import gl64 as gt
from stark_verifier_tpu_torch.ops import ntt as tn
from stark_verifier_tpu_torch.ops import ntt_np as tnp
from stark_verifier_tpu_torch.parallel.mesh import make_mesh

REPO = Path(__file__).resolve().parent.parent
P = gt.P
SIZES = [2, 8, 32, 64, 256]
SHAPES = [(), (3,), (2, 3)]


def _input(shape, n, seed):
    """Canonical words, with 0 and p - 1 in the first two places."""
    x = np.random.default_rng(seed).integers(0, P, size=shape + (n,), dtype=np.uint64)
    flat = x.reshape(-1)
    flat[0], flat[1] = 0, P - 1
    return x


def _port(fn, x, *args):
    return gt.to_u64(fn(gt.from_u64(x, "cpu"), *args))


FUNCS = {
    "ntt": (tn.ntt, tnp.ntt, rn.ntt, ()),
    "intt": (tn.intt, tnp.intt, rn.intt, ()),
    "coset_fft": (tn.coset_fft, tnp.coset_fft, rn.coset_fft, (7,)),
    "coset_lde_r2": (tn.coset_lde, tnp.coset_lde, rn.coset_lde, (2, 7)),
    "coset_lde_r3": (tn.coset_lde, tnp.coset_lde, rn.coset_lde, (3, 7)),
}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", FUNCS)
def test_equals_reference_numpy(name, n, shape):
    port, oracle, ref, args = FUNCS[name]
    x = _input(shape, n, n)
    want = ref(x, *args)
    assert np.array_equal(_port(port, x, *args), want)
    assert np.array_equal(oracle(x, *args), want)


JAX = {"ntt": (tn.ntt, rj.ntt, ()), "intt": (tn.intt, rj.intt, ()),
       "coset_fft": (tn.coset_fft, rj.coset_fft, (7,)),
       "coset_lde_r2": (tn.coset_lde, rj.coset_lde, (2, 7)),
       "coset_lde_r3": (tn.coset_lde, rj.coset_lde, (3, 7))}


# the LDEs at n <= 8 only, so that they reuse the transforms' shapes (each
# new shape is a compile); at every size they are held against numpy above
JAX_CASES = [(name, n) for name in JAX for n in (2, 8, 32, 64)
             if n <= 8 or not name.startswith("coset_lde")]


@pytest.mark.parametrize("name,n", JAX_CASES)
def test_equals_reference_jax(name, n):
    """The JAX path at one batch shape."""
    port, ref, args = JAX[name]
    x = _input((2, 3), n, 100 + n)
    want = np.asarray(gj.to_u64(ref(gj.from_u64(x), *args)))
    assert np.array_equal(_port(port, x, *args), want)


@pytest.mark.parametrize("n", SIZES)
def test_inverse_and_non_canonical_input(n):
    """intt(ntt(x)) == x; a non-canonical representative (x + p where it
    fits below 2^64) transforms like its value."""
    x = _input((3,), n, 7 * n)
    t = gt.from_u64(x, "cpu")
    assert torch.equal(tn.intt(tn.ntt(t)), t)
    small = x < np.uint64(2**64 - P)
    lifted = np.where(small, x + np.uint64(P), x)
    assert np.array_equal(_port(tn.ntt, lifted), rn.ntt(x))


def test_twiddles_are_cached_per_bits_and_device():
    tn.ntt(gt.from_u64(_input((), 16, 1), "cpu"))
    a = tn._stage_twiddles(4, torch.device("cpu"))
    assert a is tn._stage_twiddles(4, torch.device("cpu"))
    assert len(a) == 4 and [t.shape[0] for t in a] == [1, 2, 4, 8]


# ----------------------------------------------------------------- 4-step
@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh(axis="ntt")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n", [2, 64, 256])
def test_4step_on_one_rank_equals_ntt(world1, n):
    x = gt.from_u64(_input((3,), n, 11 * n), "cpu")
    assert torch.equal(tn.ntt_4step(x, world1, "ntt"), tn.ntt(x))


class _FakeMesh:
    def get_group(self, axis):
        return None


def test_4step_needs_d_squared_to_divide_n(monkeypatch):
    monkeypatch.setattr(tn.dist, "get_world_size", lambda group: 4)
    monkeypatch.setattr(tn.dist, "get_rank", lambda group: 0)
    with pytest.raises(ValueError, match="D\\^2 \\| n"):
        tn.ntt_4step(gt.zeros((2,)), _FakeMesh())     # n = 8, D^2 = 16
    with pytest.raises(ValueError):
        tn.ntt_4step(gt.zeros((3, 6)), _FakeMesh())   # n = 24, D^2 = 16


RANK = r"""
import sys
import numpy as np
import torch
from stark_verifier_tpu_torch.ops import gl64, ntt
from stark_verifier_tpu_torch.parallel.mesh import make_mesh
from stark_verifier_tpu_torch.parallel.multihost import host_batch_slice, init_distributed

rank, world, store, src, out = sys.argv[1:]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
assert init_distributed("file://" + store, world, rank, device="cpu")


def run():
    mesh = make_mesh(world, axis="ntt")
    got = {}
    for key, x in np.load(src).items():
        n = x.shape[-1]
        lo, hi = host_batch_slice(n, rank, world)
        got[key] = gl64.to_u64(ntt.ntt_4step(gl64.from_u64(x[..., lo:hi], "cpu"), mesh,
                                             "ntt"))
    np.savez(out, **got)


# The mesh holds the world's process group. A gloo group whose ranks have
# exchanged data and that is still alive when the interpreter exits aborts
# the process in its teardown now and then ("terminate called without an
# active exception", after the output is written): so the mesh goes, with
# run()'s frame, before the group is destroyed.
run()
torch.distributed.destroy_process_group()
"""

INPUTS = {f"n{n}_{len(s)}d": (s, n) for n in (64, 256) for s in ((), (3,), (2, 3))}


@pytest.fixture(scope="module")
def gloo_worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ntt4")
    src = tmp / "inputs.npz"
    np.savez(src, **{k: _input(s, n, n + len(s)) for k, (s, n) in INPUTS.items()})
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs, outs = [], {}
    for world in (2, 4):
        for r in range(world):
            outs[world, r] = tmp / f"w{world}_{r}.npz"
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK, str(r), str(world), str(tmp / f"w{world}.store"),
                 str(src), str(outs[world, r])], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, cwd=str(REPO), env=env))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return dict(np.load(src)), {k: dict(np.load(v)) for k, v in outs.items()}


@pytest.mark.parametrize("key", INPUTS)
@pytest.mark.parametrize("world", [2, 4])
def test_4step_on_gloo_worlds_equals_reference(gloo_worlds, world, key):
    """Each rank's output is its contiguous shard of the reference's NTT."""
    inputs, got = gloo_worlds
    want = rn.ntt(inputs[key])
    n = want.shape[-1]
    shards = [got[world, r][key] for r in range(world)]
    assert all(s.shape[-1] == n // world for s in shards)
    assert np.array_equal(np.concatenate(shards, axis=-1), want)
