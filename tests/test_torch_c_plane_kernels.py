"""The wrappers of the three later kernels of ops/csrc/witness.cu
(`ext2_arith`, `gl_inv` / `ext2_inv`, `poseidon_gate_eval`) and the calls
that reach them (`gl64.inv`, `ext2.inv`, `PoseidonGate.eval_unfiltered` over
the base ring, the builder's ArithmeticExtension and MulExtension
generators), on the CPU.

A CPU tensor takes the plain version, which must equal the JAX package's
C planes (`svt_ext2_arith_batch`, `svt_poseidon_eval_batch_p` through
`_poseidon_eval_native`) and numpy inverse (`gl64_np.inv`, `ext2.inv`) word
for word. A tensor on any other device reaches the kernel's library or
raises, never the plain version: a fake library, which runs each kernel's
schedule on python ints at the pointers it is given, stands for the card's.
Exact equality."""
import ctypes
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from stark_verifier_tpu import native as N
from stark_verifier_tpu.core import gates as RG
from stark_verifier_tpu.core import rings as RR
from stark_verifier_tpu.ops import ext2 as rext2
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu_torch.core import gates as TG
from stark_verifier_tpu_torch.core.rings import BaseRing
from stark_verifier_tpu_torch.core.types import CircuitConfig
from stark_verifier_tpu_torch.ops import ext2, gl64
from stark_verifier_tpu_torch.ops import witness_kernel as WK
from stark_verifier_tpu_torch.prover.builder import CircuitBuilder, WitnessStore

P = gl64.P
F = gl64.Field("cpu")
EDGES = np.array([0, 1, P - 1, P, P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1],
                 dtype=np.uint64)
CONSTANT_PAIRS = [(0, 0), (1, 0), (1, 1), (P - 1, 1), (7, P - 1), (2**63 + 5, 12345),
                  (3, 2**40 + 7)]


def _words(rng, shape, canonical=False):
    """uint64 words of `shape`, a quarter of them edge words (unless
    canonical ones are asked for)."""
    w = rng.integers(0, P if canonical else 2**64, size=shape, dtype=np.uint64)
    if not canonical:
        pick = rng.random(shape) < 0.25
        w[pick] = rng.choice(EDGES, size=int(pick.sum()))
    return w


# ------------------------------------------------- CPU: the JAX package's
@pytest.mark.parametrize("c0,c1", CONSTANT_PAIRS)
def test_ext2_arith_equals_c_plane_and_generator_body(c0, c1):
    """[2, 3, 8] operands: the port's CPU dispatch against the JAX
    package's C plane and against its numpy generator body (the fallback
    of its ArithmeticExtension generator: ext2.mul, then c0 and c1 as
    full products)."""
    rng = np.random.default_rng(100 + CONSTANT_PAIRS.index((c0, c1)))
    x, y, z = (_words(rng, (2, 3, 8), canonical=True) for _ in range(3))
    got = gl64.to_u64(WK.ext2_arith(c0, c1, F.from_u64(x), F.from_u64(y), F.from_u64(z)))
    ref = N.ext2_arith_np(c0, c1, (x[0], x[1]), (y[0], y[1]), (z[0], z[1]))
    assert np.array_equal(got, np.stack(ref))
    prod = rext2.mul(gl, (x[0], x[1]), (y[0], y[1]))
    body = [gl.add(gl.mul(gl.const(c0, x.shape[1:]), prod[k]),
                   gl.mul(gl.const(c1, x.shape[1:]), z[k])) for k in range(2)]
    assert np.array_equal(got, np.stack(body))
    # any representative in: the plain version's value mod p
    xn, yn, zn = (_words(rng, (2, 3, 8)) for _ in range(3))
    got = gl64.to_u64(WK.ext2_arith(c0, c1, F.from_u64(xn), F.from_u64(yn), F.from_u64(zn)))
    m = np.uint64(P)
    ref = N.ext2_arith_np(c0, c1, (xn[0] % m, xn[1] % m), (yn[0] % m, yn[1] % m),
                          (zn[0] % m, zn[1] % m))
    assert np.array_equal(got, np.stack(ref))


def test_gl64_inv_equals_numpy_inverse():
    """gl64.inv (today's power on the CPU) and the wrapper's CPU dispatch
    against gl64_np.inv, on edge and random words shaped [4, 25]."""
    rng = np.random.default_rng(200)
    a = _words(rng, (4, 25))
    a[0, :len(EDGES)] = EDGES
    want = gl.inv(a % np.uint64(P))
    assert np.array_equal(gl64.to_u64(gl64.inv(F.from_u64(a))), want)
    assert np.array_equal(gl64.to_u64(WK.gl_inv(F.from_u64(a))), want)


def test_ext2_inv_equals_jax_ext2_inv():
    """ext2.inv (today's formula on the CPU) and the wrapper's CPU dispatch
    against the JAX package's ext2.inv over gl64_np, every pair of edge
    words among them."""
    rng = np.random.default_rng(201)
    a = _words(rng, (2, 81 + 40))
    a[0, :81] = np.repeat(EDGES, 9)
    a[1, :81] = np.tile(EDGES, 9)
    m = np.uint64(P)
    want = np.stack(rext2.inv(gl, (a[0] % m, a[1] % m)))
    got = ext2.inv(F, (F.from_u64(a[0]), F.from_u64(a[1])))
    assert np.array_equal(np.stack([gl64.to_u64(got[0]), gl64.to_u64(got[1])]), want)
    assert np.array_equal(gl64.to_u64(WK.ext2_inv(F.from_u64(a))), want)


def test_poseidon_gate_eval_equals_native_and_base_ring():
    """2 x 1,024 points of random canonical wires (the JAX package takes
    its C plane at 1,024 points and more): the wrapper's CPU dispatch, on
    the planes of one tensor and on 135 tensors, against
    _poseidon_eval_native and the port's _poseidon_eval_base; and wires the
    fill made give 0 everywhere."""
    rng = np.random.default_rng(300)
    shape = (2, 1024)
    wires = _words(rng, (WK.FILL_WIRES,) + shape, canonical=True)
    ref = RG._poseidon_eval_native(RR.BaseRing(gl, shape), list(wires))
    assert ref is not None
    want = np.stack(ref)
    t = F.from_u64(wires)
    for planes in (t, [p.clone() for p in t]):
        assert np.array_equal(gl64.to_u64(WK.poseidon_gate_eval(planes)), want)
    base = TG._poseidon_eval_base(TG.PoseidonGate(), BaseRing(F, shape), list(t))
    assert np.array_equal(gl64.to_u64(F.stack(base)), want)
    ins = F.from_u64(_words(rng, (12, 64)))
    sw = F.from_u64(rng.integers(0, 2, 64, dtype=np.uint64))
    honest = WK.poseidon_gate_fill_plain(ins, sw)
    assert not gl64.to_u64(WK.poseidon_gate_eval(honest)).any()


def test_generators_reach_ext2_arith(monkeypatch):
    """The ArithmeticExtension and MulExtension generators: one ext2_arith
    call each (c1 = 0 for MulExtension), their outputs equal to the C
    plane's."""
    rng = np.random.default_rng(400)
    b = CircuitBuilder(CircuitConfig(), device="cpu")
    x, y, z = (b.add_virtual_targets(2) for _ in range(3))
    out_arith = b.arithmetic_extension(5, P - 3, x, y, z)
    out_mul = b.mul_extension(2**63 + 1, x, y)
    B = 6
    vals = {t: _words(rng, (B,), canonical=True) for t in x + y + z}
    s = WitnessStore(B, F)
    for t, v in vals.items():
        s.set(t, v)
    calls = []
    real = WK.ext2_arith

    def spy(*args):
        calls.append(args[:2])
        return real(*args)

    monkeypatch.setattr(WK, "ext2_arith", spy)
    for gen in b.generators:
        gen(s)
    assert calls == [(5, P - 3), ((2**63 + 1) % P, 0)]
    xs, ys, zs = ([vals[t[0]], vals[t[1]]] for t in (x, y, z))
    for out, (c0, c1) in ((out_arith, (5, P - 3)), (out_mul, ((2**63 + 1) % P, 0))):
        got = np.stack([gl64.to_u64(s.get(t)) for t in out])
        assert np.array_equal(got, np.stack(N.ext2_arith_np(c0, c1, xs, ys, zs)))


# ------------------------------------------------------ refused operands
@pytest.mark.parametrize("case", ["arith_rows", "arith_shapes", "arith_dtype", "arith_devices",
                                  "gl_inv_dtype", "ext2_inv_rows", "ext2_inv_dtype",
                                  "eval_planes", "eval_shapes", "eval_dtype", "eval_devices"])
def test_wrappers_refuse_bad_operands(case):
    """Shapes, dtypes and devices that no kernel takes raise before any
    launch: [3, S] pairs, pairs of two shapes, int32 words, operands on two
    devices, 134 planes, planes of two shapes."""
    a = torch.zeros((2, 4), dtype=torch.int64)
    meta = torch.zeros((2, 4), dtype=torch.int64, device="meta")
    planes = [torch.zeros(4, dtype=torch.int64) for _ in range(WK.FILL_WIRES)]
    calls = {
        "arith_rows": (ValueError, lambda: WK.ext2_arith(1, 1, a[:1], a[:1], a[:1])),
        "arith_shapes": (ValueError, lambda: WK.ext2_arith(1, 1, a, a[:, :3], a)),
        "arith_dtype": (TypeError, lambda: WK.ext2_arith(1, 1, a, a.int(), a)),
        "arith_devices": (ValueError, lambda: WK.ext2_arith(1, 1, a, meta, a)),
        "gl_inv_dtype": (TypeError, lambda: WK.gl_inv(a.int())),
        "ext2_inv_rows": (ValueError, lambda: WK.ext2_inv(torch.zeros((3, 4), dtype=torch.int64))),
        "ext2_inv_dtype": (TypeError, lambda: WK.ext2_inv(a.to(torch.float64))),
        "eval_planes": (ValueError, lambda: WK.poseidon_gate_eval(planes[:-1])),
        "eval_shapes": (ValueError, lambda: WK.poseidon_gate_eval(
            planes[:-1] + [torch.zeros(5, dtype=torch.int64)])),
        "eval_dtype": (TypeError, lambda: WK.poseidon_gate_eval(
            planes[:-1] + [planes[0].int()])),
        "eval_devices": (ValueError, lambda: WK.poseidon_gate_eval(
            planes[:-1] + [meta[0]])),
    }
    error, call = calls[case]
    with pytest.raises(error):
        call()


@pytest.fixture
def no_plain(monkeypatch):
    """Every plain version raises: a call that reaches one fails the test."""
    def refuse(*args, **kw):
        raise AssertionError("a plain version ran for a tensor off the CPU")

    for name in ("ext2_arith_plain", "gl_inv_plain", "ext2_inv_plain",
                 "poseidon_gate_eval_plain"):
        monkeypatch.setattr(WK, name, refuse)
    monkeypatch.setattr(gl64, "pow_const", refuse)
    monkeypatch.setattr(TG, "_poseidon_eval_base", refuse)


@pytest.mark.parametrize("call", ["gl64.inv", "ext2.inv", "ext2_arith", "eval_unfiltered"])
def test_tensor_off_the_cpu_never_takes_the_plain_version(no_plain, call):
    """A tensor on a device other than the CPU (here "meta", which has no
    kernel) goes to the kernel's wrapper, which raises: no plain version,
    no CPU copy."""
    m = torch.zeros((2, 3), dtype=torch.int64, device="meta")
    calls = {"gl64.inv": lambda: gl64.inv(m),
             "ext2.inv": lambda: ext2.inv(gl64.Field("meta"), (m[0], m[1])),
             "ext2_arith": lambda: WK.ext2_arith(3, 4, m, m, m),
             "eval_unfiltered": lambda: TG.PoseidonGate().eval_unfiltered(
                 BaseRing(gl64.Field("meta"), (3,)), [], [m[0]] * WK.FILL_WIRES, None)}
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        calls[call]()


# ------------------------------------------------------ the fake library
def _u64(ptr, n):
    return (ctypes.c_uint64 * n).from_address(ptr)


class _FakeWitnessLibrary:
    """The library's six C entry points, each running its kernel's
    schedule on python ints at the device pointers it gets, as the card
    runs the kernel there; `fail[name]` returns that CUDA error instead."""

    def __init__(self):
        self.calls, self.fail = [], {}

    def _record(self, name, args):
        self.calls.append((name, args))
        return self.fail.get(name, 0)

    def ext2_arith(self, c0, c1, x, y, z, out, L, stream):
        if self._record("ext2_arith", (c0, c1, x, y, z, out, L)):
            return self.fail["ext2_arith"]
        xs, ys, zs, o = _u64(x, 2 * L), _u64(y, 2 * L), _u64(z, 2 * L), _u64(out, 2 * L)
        for i in range(L):
            o[i], o[L + i] = WK.schedule_arith_ints(c0, c1, (xs[i], xs[L + i]),
                                                    (ys[i], ys[L + i]), (zs[i], zs[L + i]))
        return 0

    def poseidon_gate_fill(self, ins, swap, out, L, stream):
        if self._record("poseidon_gate_fill", (ins, swap, out, L)):
            return self.fail["poseidon_gate_fill"]
        x, sw, o = _u64(ins, WK.WIDTH * L), _u64(swap, L), _u64(out, WK.FILL_WIRES * L)
        for i in range(L):
            wires = WK.schedule_fill_ints([x[q * L + i] for q in range(WK.WIDTH)], sw[i])
            for k, v in enumerate(wires):
                o[k * L + i] = v
        return 0

    def ext2_reduce_chain(self, alpha, acc, coeffs, out, k, L, stream):
        if self._record("ext2_reduce_chain", (alpha, acc, coeffs, out, k, L)):
            return self.fail["ext2_reduce_chain"]
        a, x = _u64(alpha, 2 * L), _u64(acc, 2 * L)
        c, o = _u64(coeffs, 2 * k * L), _u64(out, 2 * k * L)
        for i in range(L):
            steps = [(c[2 * j * L + i], c[(2 * j + 1) * L + i]) for j in range(k)]
            accs = WK.schedule_chain_ints((a[i], a[L + i]), (x[i], x[L + i]), steps)
            for j, (v0, v1) in enumerate(accs):
                o[2 * j * L + i], o[(2 * j + 1) * L + i] = v0, v1
        return 0

    def gl_inv(self, a, out, L, stream):
        if self._record("gl_inv", (a, out, L)):
            return self.fail["gl_inv"]
        src, o = _u64(a, L), _u64(out, L)
        for i in range(L):
            o[i] = WK.schedule_inv_ints(src[i])
        return 0

    def ext2_inv(self, a, out, L, stream):
        if self._record("ext2_inv", (a, out, L)):
            return self.fail["ext2_inv"]
        src, o = _u64(a, 2 * L), _u64(out, 2 * L)
        for i in range(L):
            o[i], o[L + i] = WK.schedule_ext2_inv_ints((src[i], src[L + i]))
        return 0

    def poseidon_gate_eval(self, wires, stride, out, L, stream):
        if self._record("poseidon_gate_eval", (wires, stride, out, L)):
            return self.fail["poseidon_gate_eval"]
        o = _u64(out, WK.EVAL_CONSTRAINTS * L)
        planes = [_u64(wires + 8 * k * stride, L) for k in range(WK.FILL_WIRES)]
        for i in range(L):
            for c, v in enumerate(WK.schedule_eval_ints([p[i] for p in planes])):
                o[c * L + i] = v
        return 0


@pytest.fixture
def card(monkeypatch):
    """CPU tensors taken for the card's: the wrappers' device check says
    "cuda", the library is the fake, the counts start at 0."""
    lib = _FakeWitnessLibrary()
    monkeypatch.setattr(WK, "_device_of", lambda *tensors: "cuda")
    monkeypatch.setattr(WK, "_library", lambda device: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(WK, "LAUNCHES", {name: 0 for name in WK.KERNELS})
    return lib


def _counts(**launched):
    return {name: launched.get(name, 0) for name in WK.KERNELS}


@pytest.mark.parametrize("lanes", [0, 1, 5])
def test_fake_card_launches_ext2_arith_and_inverses(card, no_plain, lanes):
    """Each call is one launch of its kernel at the flattened lane count,
    its result the schedule's at the wrapper's pointers; 0 lanes launch
    and count nothing."""
    rng = np.random.default_rng(500 + lanes)
    x, y, z = (F.from_u64(_words(rng, (2, 1, lanes))) for _ in range(3))
    got = WK.ext2_arith(2**63 + 5, P - 1, x, y, z)
    assert got.shape == (2, 1, lanes)
    a = F.from_u64(_words(rng, (lanes,)))
    inv = WK.gl_inv(a)
    einv = WK.ext2_inv(x)
    if lanes == 0:
        assert card.calls == [] and WK.LAUNCHES == _counts()
        return
    assert [name for name, _ in card.calls] == ["ext2_arith", "gl_inv", "ext2_inv"]
    assert card.calls[0][1][:2] == ((2**63 + 5) % P, P - 1)
    assert WK.LAUNCHES == _counts(ext2_arith=1, gl_inv=1, ext2_inv=1)
    xs, ys, zs = (gl64.to_u64(t).reshape(2, lanes) for t in (x, y, z))
    want = [WK.schedule_arith_ints(2**63 + 5, P - 1, xs[:, i], ys[:, i], zs[:, i])
            for i in range(lanes)]
    assert np.array_equal(gl64.to_u64(got).reshape(2, lanes), np.array(want, np.uint64).T)
    assert gl64.to_u64(inv).tolist() == [pow(int(v), P - 2, P) for v in gl64.to_u64(a)]
    assert np.array_equal(gl64.to_u64(einv).reshape(2, lanes), np.array(
        [WK.schedule_ext2_inv_ints(xs[:, i]) for i in range(lanes)], np.uint64).T)


@pytest.mark.parametrize("lanes", [0, 1, 3])
def test_fake_card_launches_fill_and_chain(card, lanes, monkeypatch):
    """The two witness kernels go through the same launch: one counted
    launch each at the flattened lane count, the results their schedules',
    equal to their plain versions; 0 lanes launch nothing."""
    rng = np.random.default_rng(550 + lanes)
    ins = F.from_u64(_words(rng, (12, 1, lanes)))
    sw = F.from_u64(rng.integers(0, 2, (1, lanes), dtype=np.uint64))
    alpha, acc = (F.from_u64(_words(rng, (2, 1, lanes))) for _ in range(2))
    coeffs = F.from_u64(_words(rng, (5, 2, 1, lanes)))
    wires = WK.poseidon_gate_fill(ins, sw)
    accs = WK.ext2_reduce_chain(alpha, acc, coeffs)
    assert wires.shape == (WK.FILL_WIRES, 1, lanes) and accs.shape == (5, 2, 1, lanes)
    if lanes == 0:
        assert card.calls == [] and WK.LAUNCHES == _counts()
        return
    assert [name for name, _ in card.calls] == ["poseidon_gate_fill", "ext2_reduce_chain"]
    assert WK.LAUNCHES == _counts(poseidon_gate_fill=1, ext2_reduce_chain=1)
    assert torch.equal(wires, WK.poseidon_gate_fill_plain(ins, sw))
    assert torch.equal(accs, WK.ext2_reduce_chain_plain(alpha, acc, coeffs))


def test_fake_card_eval_reads_consecutive_planes_in_place(card, no_plain):
    """The quotient's planes, consecutive slices of one [135 + 8, B, n]
    tensor: one launch at B * n lanes, its pointer the tensor's own and its
    stride B * n words (no stacked copy); 135 separate tensors are stacked
    first. Both give the schedule's constraints."""
    rng = np.random.default_rng(600)
    wire_lde = F.from_u64(_words(rng, (WK.FILL_WIRES + 8, 2, 3)))
    got = WK.poseidon_gate_eval(list(wire_lde)[:WK.FILL_WIRES])
    (name, (ptr, stride, _, lanes)), = card.calls
    assert (name, ptr, stride, lanes) == ("poseidon_gate_eval", wire_lde.data_ptr(), 6, 6)
    w = gl64.to_u64(wire_lde).reshape(WK.FILL_WIRES + 8, 6)
    want = np.array([WK.schedule_eval_ints(w[:WK.FILL_WIRES, i]) for i in range(6)],
                    dtype=np.uint64).T.reshape(WK.EVAL_CONSTRAINTS, 2, 3)
    assert np.array_equal(gl64.to_u64(got), want)
    apart = [p.clone() for p in wire_lde[:WK.FILL_WIRES]]
    again = WK.poseidon_gate_eval(apart)
    assert card.calls[1][1][0] not in {p.data_ptr() for p in apart}
    assert card.calls[1][1][1] == 6
    assert torch.equal(again, got)
    assert WK.LAUNCHES == _counts(poseidon_gate_eval=2)


def test_fake_card_eval_unfiltered_dispatches_to_the_kernel(card, no_plain):
    """PoseidonGate.eval_unfiltered over the base ring of a CUDA device
    returns the kernel's 123 rows, one launch; the extension ring (the
    verifier's) does not launch it."""
    rng = np.random.default_rng(700)
    wires = F.from_u64(_words(rng, (WK.FILL_WIRES + 3, 4)))
    R = BaseRing(gl64.Field("cuda"), (4,))
    out = TG.PoseidonGate().eval_unfiltered(R, [], list(wires), None)
    assert len(out) == WK.EVAL_CONSTRAINTS and all(c.shape == (4,) for c in out)
    assert WK.LAUNCHES == _counts(poseidon_gate_eval=1)


@pytest.mark.parametrize("name", ["ext2_arith", "gl_inv", "ext2_inv", "poseidon_gate_eval"])
def test_fake_card_error_raises(card, no_plain, name):
    """A nonzero CUDA error from the entry point raises and counts no
    launch; the plain version is not tried."""
    card.fail[name] = 719
    a = torch.ones((2, 3), dtype=torch.int64)
    calls = {"ext2_arith": lambda: WK.ext2_arith(1, 2, a, a, a),
             "gl_inv": lambda: WK.gl_inv(a[0]),
             "ext2_inv": lambda: WK.ext2_inv(a),
             "poseidon_gate_eval": lambda: WK.poseidon_gate_eval(
                 torch.ones((WK.FILL_WIRES, 3), dtype=torch.int64))}
    with pytest.raises(RuntimeError, match=f"{name} launch failed: CUDA error 719"):
        calls[name]()
    assert WK.LAUNCHES == _counts()


def test_fake_card_library_binds_every_entry_point(monkeypatch):
    """The loader binds each new entry point's C signature (64-bit pointers
    and lane counts, the constants as u64) and its int return."""
    class Fn:
        argtypes = restype = None

        def __call__(self, *args):
            return WK.fill_tables().size if self is fns.get("witness_table_words") else 0

    fns = {}
    lib = SimpleNamespace()
    monkeypatch.setattr("stark_verifier_tpu_torch.ops.cuda_build.load",
                        lambda name: lib)
    monkeypatch.setattr("stark_verifier_tpu_torch.ops.cuda_build._bound", set())
    monkeypatch.setattr("stark_verifier_tpu_torch.ops.cuda_build._served", {})
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    for name in WK.KERNELS + ("witness_set_tables", "witness_table_words", "witness_empty"):
        fns[name] = Fn()
        setattr(lib, name, fns[name])
    assert WK._library(torch.device("cuda", 0)) is lib
    c = ctypes
    assert fns["ext2_arith"].argtypes == [c.c_uint64, c.c_uint64] + [c.c_void_p] * 4 + [
        c.c_longlong, c.c_void_p]
    assert fns["gl_inv"].argtypes == fns["ext2_inv"].argtypes == [
        c.c_void_p, c.c_void_p, c.c_longlong, c.c_void_p]
    assert fns["poseidon_gate_eval"].argtypes == [c.c_void_p, c.c_longlong, c.c_void_p,
                                                  c.c_longlong, c.c_void_p]
    assert all(fns[name].restype is c.c_int for name in WK.KERNELS)
