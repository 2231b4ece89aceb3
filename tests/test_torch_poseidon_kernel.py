"""stark_verifier_tpu_torch.ops.poseidon_kernel on the CPU: `permute_plain`
(the plain PyTorch version the Hopper kernel is held against on the card, and
what `permute` runs for a CPU tensor) against the Pallas TPU kernel itself in
interpret mode, its planes formulation, the numpy golden model and plonky2's
published vectors. Exact equality throughout; the CUDA kernel itself can only
run on a GPU and is compared with `permute_plain` there by chip_smoke.py."""
import numpy as np
import pytest
import torch

from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.ops import poseidon_gl as pg
from stark_verifier_tpu.ops.pallas import poseidon_kernel as pk
from stark_verifier_tpu_torch.ops import gl64 as gt
from stark_verifier_tpu_torch.ops import poseidon_kernel as tk
from test_external_anchor import PLONKY2_TEST_VECTORS_12

P = gt.P
EDGES = np.array(
    [0, 1, P - 1, P, P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1], dtype=np.uint64)


def _state(seed, lanes):
    """uint64[12, lanes], full-range words; every edge value visits every
    state position (cycling through the lanes there are)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2**64, size=(12, lanes), dtype=np.uint64)
    for pos in range(12):
        for k, e in enumerate(EDGES):
            lane = (pos * len(EDGES) + k) % lanes
            if lanes >= 12 * len(EDGES) or (pos + k) % 3 == 0:
                s[pos, lane] = e
    return s


def _planes(state):
    import jax.numpy as jnp

    lo = jnp.asarray((state & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((state >> np.uint64(32)).astype(np.uint32))
    return lo, hi


def _join(out_lo, out_hi):
    return np.asarray(out_lo, dtype=np.uint64) | (
        np.asarray(out_hi, dtype=np.uint64) << np.uint64(32))


def _torch_permute(fn, state):
    return gt.to_u64(fn(gt.from_u64(state, "cpu")))


def _golden(state):
    return pg.permute(gl, state % np.uint64(P))


@pytest.mark.parametrize("lanes", [1, 5, 128, 200])
def test_permute_plain_matches_planes_and_golden(lanes):
    state = _state(lanes, lanes)
    got = _torch_permute(tk.permute_plain, state)
    assert (got == _join(*pk._permute_planes(*_planes(state)))).all()
    assert (got == _golden(state)).all()
    assert (got < np.uint64(P)).all()  # canonical output


def test_permute_plain_matches_pallas_kernel_interpret():
    """The TPU kernel this port's kernel replaces (pure vector-unit body,
    mxu=0), run by the Pallas interpreter on the CPU."""
    state = _state(7, 128)
    lo, hi = _planes(state)
    out_lo, out_hi = pk.poseidon_permute_batch(
        lo, hi, interpret=True, block_b=128, mxu=0)
    assert (_torch_permute(tk.permute_plain, state) == _join(out_lo, out_hi)).all()


@pytest.mark.parametrize("lanes", [1, 5, 200])
def test_cpu_wrapper_takes_plain_version_and_counts_no_launch(lanes):
    state = _state(100 + lanes, lanes)
    before = dict(tk.LAUNCHES)
    got = _torch_permute(tk.permute, state)
    assert tk.LAUNCHES == before
    assert (got == _golden(state)).all()


def test_wrapper_flattens_trailing_dims():
    state = _state(3, 120)
    flat = _torch_permute(tk.permute, state)
    shaped = _torch_permute(tk.permute, state.reshape(12, 4, 30))
    assert shaped.shape == (12, 4, 30)
    assert (shaped.reshape(12, 120) == flat).all()


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    if bad == "dtype":
        with pytest.raises(TypeError):
            tk.permute(torch.zeros((12, 4), dtype=torch.int32))
    else:
        with pytest.raises(ValueError):
            tk.permute(torch.zeros((8, 4), dtype=torch.int64))


@pytest.mark.parametrize("ins,expected", PLONKY2_TEST_VECTORS_12)
@pytest.mark.parametrize("fn", ["permute", "permute_plain"])
def test_plonky2_published_vectors(fn, ins, expected):
    state = np.array(ins, dtype=np.uint64).reshape(12, 1)
    out = _torch_permute(getattr(tk, fn), state)
    assert [int(x) for x in out.ravel()] == expected


def test_u64_max_input_is_read_as_noncanonical():
    """plonky2's third vector feeds all-u64::MAX through
    from_noncanonical_u64: the words stand for 2^64 - 1 - p."""
    state = np.full((12, 1), 2**64 - 1, dtype=np.uint64)
    got = _torch_permute(tk.permute_plain, state)
    canon = np.full((12, 1), (2**64 - 1) % P, dtype=np.uint64)
    assert (got == pg.permute(gl, canon)).all()
    assert (got == _torch_permute(tk.permute_plain, canon)).all()
