"""stark_verifier_tpu_torch.ops.gl64 (int64 tensors, CPU) against the JAX
package's u64 backend on XLA:CPU (`gl64_cpu`), its numpy golden model
(`gl64_np`) and python-int arithmetic. Every comparison is exact equality of
canonical uint64 values: this is modular arithmetic, there is no tolerance.
Inputs are random full-range words plus an edge set used as NON-canonical
representatives."""
import itertools

import numpy as np
import pytest
import torch

from stark_verifier_tpu.ops import gl64_cpu as gc
from stark_verifier_tpu.ops import gl64_np as gnp
from stark_verifier_tpu_torch.ops import gl64 as gt

P = gt.P
EDGES = [0, 1, P - 1, P, P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1]
F = gt.Field("cpu")
rng = np.random.default_rng(1)


def _inputs():
    """Two uint64 vectors: every ordered edge pair, then random words."""
    pairs = list(itertools.product(EDGES, EDGES))
    a = np.array([p[0] for p in pairs], dtype=np.uint64)
    b = np.array([p[1] for p in pairs], dtype=np.uint64)
    ra = rng.integers(0, 2**64, size=400, dtype=np.uint64)
    rb = rng.integers(0, 2**64, size=400, dtype=np.uint64)
    return np.concatenate([a, ra]), np.concatenate([b, rb])


A, B = _inputs()
A_INT = [int(x) for x in A]
B_INT = [int(x) for x in B]


def _canon(x):
    return np.asarray(x, np.uint64) % np.uint64(P)


def _ints(vals):
    return np.array([v % P for v in vals], dtype=np.uint64)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_op(op):
    got = F.to_u64(getattr(F, op)(F.from_u64(A), F.from_u64(B)))
    py = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
          "mul": lambda x, y: x * y}[op]
    assert (got == _ints([py(x, y) for x, y in zip(A_INT, B_INT)])).all()
    assert (got == getattr(gnp, op)(_canon(A), _canon(B))).all()
    jx = getattr(gc, op)(gc.from_u64(A), gc.from_u64(B))
    assert (got == gc.to_u64(jx)).all()


def test_mul_add():
    C = np.roll(A, 7)
    got = F.to_u64(F.mul_add(F.from_u64(A), F.from_u64(B), F.from_u64(C)))
    want = _ints([x * y + z for x, y, z in zip(A_INT, B_INT, A_INT[-7:] + A_INT[:-7])])
    assert (got == want).all()
    jx = gc.mul_add(gc.from_u64(A), gc.from_u64(B), gc.from_u64(C))
    assert (got == gc.to_u64(jx)).all()


@pytest.mark.parametrize("op", ["neg", "square", "canonical"])
def test_unary_op(op):
    got = F.to_u64(getattr(F, op)(F.from_u64(A)))
    py = {"neg": lambda x: -x, "square": lambda x: x * x,
          "canonical": lambda x: x}[op]
    assert (got == _ints([py(x) for x in A_INT])).all()
    assert (got == gc.to_u64(getattr(gc, op)(gc.from_u64(A)))).all()


def test_results_stay_in_u64_and_canonical_is_below_p():
    x = F.canonical(F.mul(F.from_u64(A), F.from_u64(B)))
    assert x.dtype == torch.int64
    assert (x.numpy().view(np.uint64) < np.uint64(P)).all()


@pytest.mark.parametrize("k", [0, 1, 2, 7, 41, 264, (1 << 15) - 1])
def test_mul_small(k):
    got = F.to_u64(F.mul_small(F.from_u64(A), k))
    assert (got == _ints([x * k for x in A_INT])).all()
    assert (got == gc.to_u64(gc.mul_small(gc.from_u64(A), k))).all()


@pytest.mark.parametrize("e", [0, 1, 2, 7, 8, 31, 1 << 20, P - 2])
def test_pow_const(e):
    a = A[:120]
    got = F.to_u64(F.pow_const(F.from_u64(a), e))
    assert (got == _ints([pow(int(x), e, P) for x in a])).all()
    assert (got == gnp.pow_const(_canon(a), e)).all()


def test_inv_and_its_zero_convention():
    a = A[:120]
    x = F.from_u64(a)
    got = F.to_u64(F.inv(x))
    assert (got == gnp.inv(_canon(a))).all()
    assert (got == gc.to_u64(gc.inv(gc.from_u64(a)))).all()
    # inv(0) = 0, for both representatives of zero
    assert (F.to_u64(F.inv(F.from_u64(np.array([0, P], np.uint64)))) == 0).all()
    nz = _canon(a) != 0
    prod = F.to_u64(F.mul(x, F.inv(x)))
    assert (prod[nz] == 1).all() and (prod[~nz] == 0).all()


@pytest.mark.parametrize("i", [0, 1, 31, 32, 33, 62, 63])
def test_bit(i):
    got = F.bit(F.from_u64(A), i)
    assert got.dtype == torch.int64
    want = np.array([((x % P) >> i) & 1 for x in A_INT])
    assert (got.numpy() == want).all()
    assert (got.numpy() == np.asarray(gc.bit(gc.from_u64(A), i))).all()


@pytest.mark.parametrize("bits", [1, 4, 12, 31, 32])
def test_mod_pow2(bits):
    got = F.mod_pow2(F.from_u64(A), bits).numpy()
    assert (got == np.array([(x % P) % (1 << bits) for x in A_INT])).all()
    assert (got == np.asarray(gc.mod_pow2(gc.from_u64(A), bits))).all()


def test_is_zero_and_equal_canonicalise():
    z = F.is_zero(F.from_u64(A)).numpy()
    assert (z == np.array([x % P == 0 for x in A_INT])).all()
    assert (z == np.asarray(gc.is_zero(gc.from_u64(A)))).all()
    eq = F.equal(F.from_u64(A), F.from_u64(B)).numpy()
    assert (eq == np.array([x % P == y % P for x, y in zip(A_INT, B_INT)])).all()
    assert (eq == np.asarray(gc.equal(gc.from_u64(A), gc.from_u64(B)))).all()
    # p and 0, p + 1 and 1 are equal elements in different words
    assert bool(F.equal(F.from_u64(P), F.from_u64(0)))
    assert bool(F.equal(F.from_u64(P + 1), F.from_u64(1)))


def test_from_to_u64_const_zeros_ones():
    assert (F.to_u64(F.from_u64(A)) == _canon(A)).all()
    assert F.from_u64(A).dtype == torch.int64
    for v in EDGES + [P + 5, 3 * P + 2, -1]:
        c = F.const(v, (3,))
        assert c.shape == (3,) and (F.to_u64(c) == np.uint64(v % P)).all()
        assert (F.to_u64(c) == gc.to_u64(gc.const(v, (3,)))).all()
    assert (F.to_u64(F.zeros((2, 3))) == 0).all()
    assert (F.to_u64(F.ones((2, 3))) == 1).all()
    assert F.zeros().shape == () and F.ones().shape == ()


def test_structure_ops():
    m = A[:480].reshape(12, 40)
    x = F.from_u64(m)
    jx = gc.from_u64(m)
    mask = rng.random((12, 40)) < 0.5
    y = F.from_u64(B[:480].reshape(12, 40))
    sel = F.select(torch.from_numpy(mask), x, y)
    assert (F.to_u64(sel) == _canon(np.where(mask, m, B[:480].reshape(12, 40)))).all()
    rows = F.unstack(x)
    assert len(rows) == 12 and (F.to_u64(rows[5]) == _canon(m[5])).all()
    assert (F.to_u64(F.stack(rows)) == _canon(m)).all()
    assert (F.to_u64(F.stack(rows, axis=-1)) == _canon(m.T)).all()
    # stack broadcasts a scalar against lanes
    st = F.stack([rows[0], F.const(5)])
    assert st.shape == (2, 40) and (F.to_u64(st[1]) == 5).all()
    cc = F.concat([x[:3], x[7:]], axis=0)
    assert (F.to_u64(cc) == _canon(np.concatenate([m[:3], m[7:]]))).all()
    idx = np.array([[3, 0], [11, 3]])
    tk = F.take(x, torch.from_numpy(idx), axis=0)
    assert tk.shape == (2, 2, 40)
    assert (F.to_u64(tk) == _canon(np.take(m, idx, axis=0))).all()
    assert (F.to_u64(tk) == gc.to_u64(gc.take(jx, idx, axis=0))).all()
    assert (F.to_u64(F.index(x, (slice(1, 4), 2))) == _canon(m[1:4, 2])).all()
    assert (F.to_u64(F.reshape(x, (4, 3, 40))) == _canon(m.reshape(4, 3, 40))).all()


def test_sum_axis0():
    m = np.concatenate([A, B])[:960].reshape(24, 40)
    got = F.to_u64(F.sum_axis0(F.from_u64(m)))
    want = _ints([sum(int(v) for v in m[:, j]) for j in range(40)])
    assert (got == want).all()
    assert (got == gc.to_u64(gc.sum_axis0(gc.from_u64(m)))).all()
    worst = np.full((100, 3), 2**64 - 1, dtype=np.uint64)
    assert (F.to_u64(F.sum_axis0(F.from_u64(worst)))
            == np.uint64((100 * (2**64 - 1)) % P)).all()


def test_mds12():
    m = A[:480].reshape(12, 40)
    m[:, 0] = 2**64 - 1  # the widest sums
    got = F.to_u64(F.mds12(F.from_u64(m)))
    assert (got == gnp.mds12(_canon(m))).all()
    assert (got == gc.to_u64(gc.mds12(gc.from_u64(m)))).all()
    x3 = F.from_u64(m.reshape(12, 8, 5))
    assert (F.to_u64(F.mds12(x3)).reshape(12, 40) == got).all()


def test_permute12():
    m = A[:480].reshape(12, 40)
    got = F.to_u64(F.permute12(F.from_u64(m)))
    assert (got == gnp.permute12(_canon(m))).all()
    assert (got == gc.to_u64(gc.permute12(gc.from_u64(m)))).all()
