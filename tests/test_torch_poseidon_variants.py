"""The tensor-core variants of the Poseidon kernel on the CPU: the byte-split
MDS and `permute_plain(state, mxu=1|2)` (the plain PyTorch versions that
poseidon_permute_mma and poseidon_permute_mma2 are held against on the card,
and what `permute` runs for a CPU tensor) against the TPU kernels they stand
for (`_mds_mxu`, `_kernel_mxu`, `_kernel_mxu2`, the latter two run by the
Pallas interpreter) and against the numpy golden model. Exact equality
throughout. The CUDA kernels themselves run only on a GPU: chip_smoke.py
compares them there."""
import numpy as np
import pytest
import torch

from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu.ops import poseidon_gl as pg
from stark_verifier_tpu.ops.pallas import poseidon_kernel as pk
from stark_verifier_tpu_torch.ops import gl64 as gt
from stark_verifier_tpu_torch.ops import poseidon_gl as tpg
from stark_verifier_tpu_torch.ops import poseidon_kernel as tk

P = gt.P
EDGES = np.array(
    [0, 1, P - 1, P, P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1], dtype=np.uint64)
F = gt.Field("cpu")


def _state(seed, lanes):
    """uint64[12, lanes], full-range words; every edge value visits every
    state position (cycling through the lanes there are, so with few lanes
    a later value overwrites an earlier one: `offset` rotates which)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2**64, size=(12, lanes), dtype=np.uint64)
    for pos in range(12):
        for k, e in enumerate(EDGES):
            s[pos, (pos * len(EDGES) + k + seed) % lanes] = e
    return s


def _planes(state):
    import jax.numpy as jnp

    lo = jnp.asarray((state & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((state >> np.uint64(32)).astype(np.uint32))
    return lo, hi


def _join(out_lo, out_hi):
    return np.asarray(out_lo, dtype=np.uint64) | (
        np.asarray(out_hi, dtype=np.uint64) << np.uint64(32))


def _torch(fn, state, *args):
    return gt.to_u64(fn(gt.from_u64(state, "cpu"), *args))


def _golden(state):
    return pg.permute(gl, state % np.uint64(P))


@pytest.mark.parametrize("lanes", [1, 64, 200])
def test_byte_split_mds_matches_mxu_mds_and_golden(lanes):
    """gl64.mds12_bytes against the TPU's matrix-unit MDS `_mds_mxu` (same
    limb split, f32 product) and against the golden mds12, on full-range
    words (non-canonical ones and all-0xFF bytes included)."""
    import jax.numpy as jnp

    state = _state(lanes, lanes)
    got = _torch(gt.mds12_bytes, state)
    out_lo, out_hi = pk._mds_mxu(*_planes(state), jnp.asarray(pk._MDS_F32))
    assert (got == _join(out_lo, out_hi) % np.uint64(P)).all()
    canon = state % np.uint64(P)
    expect = np.stack([gl.mds12(canon[:, b]) for b in range(lanes)], axis=1)
    assert (got == expect).all()
    assert (got == _torch(gt.mds12, state)).all()


def test_byte_split_mds_keeps_trailing_shape():
    state = _state(5, 120)
    flat = _torch(gt.mds12_bytes, state)
    shaped = _torch(gt.mds12_bytes, state.reshape(12, 4, 30))
    assert shaped.shape == (12, 4, 30)
    assert (shaped.reshape(12, 120) == flat).all()


@pytest.mark.parametrize("mxu,block_b", [
    (1, 128), pytest.param(2, 256, marks=pytest.mark.time_limit(240))])
def test_permute_plain_matches_pallas_kernel_interpret(mxu, block_b):
    """The TPU kernels these variants replace (`_kernel_mxu` at mxu=1,
    `_kernel_mxu2` at mxu=2 with a 256-lane tile), run by the Pallas
    interpreter on the CPU, 256 lanes. Tracing and lowering the interpreted
    kernel, not its lanes, take the time: ~30 s at mxu=1 and ~60 s at
    mxu=2 (its time_limit)."""
    state = _state(40 + mxu, 256)
    out_lo, out_hi = pk.poseidon_permute_batch(
        *_planes(state), interpret=True, block_b=block_b, mxu=mxu)
    assert (_torch(tk.permute_plain, state, mxu) == _join(out_lo, out_hi)).all()


@pytest.mark.parametrize("lanes", [1, 5, 200, 257])
@pytest.mark.parametrize("mxu", [1, 2])
def test_permute_plain_matches_golden(mxu, lanes):
    """Odd lane counts and one lane (the second stream of mxu=2 is then
    ragged or empty), edge values in every state position."""
    state = _state(7 * lanes + mxu, lanes)
    got = _torch(tk.permute_plain, state, mxu)
    assert (got == _golden(state)).all()
    assert (got < np.uint64(P)).all()  # canonical output


@pytest.mark.parametrize("mxu", [0, 1, 2])
def test_cpu_wrapper_takes_plain_version_and_counts_no_launch(mxu):
    state = _state(100 + mxu, 37)
    before = dict(tk.LAUNCHES)
    got = _torch(tk.permute, state, mxu)
    assert tk.LAUNCHES == before and set(before) == set(tk.KERNELS)
    assert (got == _golden(state)).all()
    x = gt.from_u64(state, "cpu")
    assert torch.equal(tpg.permute(F, x, mxu), tk.permute_plain(x, mxu))
    assert torch.equal(tpg.permute_plain(F, x, mxu), tk.permute_plain(x, 0))
    shaped = tk.permute(x[:, :36].reshape(12, 3, 12).contiguous(), mxu)
    assert torch.equal(shaped.reshape(12, 36), tk.permute(x[:, :36].contiguous(), mxu))


@pytest.mark.parametrize("bad", [3, -1, "1", 1.5])
def test_wrapper_rejects_a_bad_mxu(bad):
    x = gt.from_u64(_state(1, 4), "cpu")
    with pytest.raises(ValueError, match="mxu"):
        tk.permute(x, bad)
    with pytest.raises(ValueError, match="mxu"):
        tk.permute_plain(x, bad)


@pytest.mark.parametrize("value,expect", [(None, 0), ("0", 0), ("1", 1), ("2", 2), ("", 0)])
def test_environment_variable_selects_the_variant(monkeypatch, value, expect):
    if value is None:
        monkeypatch.delenv("SVT_POSEIDON_MXU", raising=False)
    else:
        monkeypatch.setenv("SVT_POSEIDON_MXU", value)
    assert tk._use_mxu() == expect
    seen = []
    monkeypatch.setattr(tk, "permute_plain",
                        lambda state, mxu=0: seen.append(mxu) or state)
    tk.permute(gt.from_u64(_state(2, 3), "cpu"))
    assert seen == [expect]


def test_environment_variable_out_of_range_is_refused(monkeypatch):
    monkeypatch.setenv("SVT_POSEIDON_MXU", "7")
    with pytest.raises(ValueError, match="mxu"):
        tk.permute(gt.from_u64(_state(2, 3), "cpu"))
