"""The elementwise field plane of ops/csrc/field.cu (`gl_mul`, `gl_add`,
`gl_sub`, `gl_mul_add`, `gl_mul_small`) and its wrappers in
ops/field_kernel.py, on the CPU.

The kernels must give the plain versions' own words (`gl64.mul_plain` ...
`gl64.mul_small_plain`), not only equal values mod p, so every comparison
here is exact:

  * the schedule (`schedule_field_ints`, one thread's arithmetic on python
    ints) against the plain versions, on every pair of edge words and on
    seeded random ones;
  * the launch geometry (`launch_args`: the broadcast shape collapsed, each
    operand's strides) through a numpy emulation of the kernel's index
    arithmetic, for every operand form the paths give: equal, broadcast,
    0-dim, strided, transposed, empty, gl64.neg's null operand;
  * every call the zk20 verifier makes on its CPU path (first 4 proofs of
    sem_zk20b64.npz) through the same geometry and emulation, and the calls
    counted against the launches chip_smoke.py pins a batch;
  * the port's field functions against the JAX package's numpy field
    (`gl64_np`) after canonicalisation, the reference's form;
  * the dispatch: a tensor off the CPU reaches the launcher (a fake library
    that runs the schedule at the pointers it is given) and never a plain
    version; a failed launch raises.
"""
import ctypes
import importlib.util
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch

from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu_torch.core.types import load_proofs
from stark_verifier_tpu_torch.models import flagship as FS
from stark_verifier_tpu_torch.ops import ext2, gl64
from stark_verifier_tpu_torch.ops import field_kernel as FK

REPO = Path(__file__).resolve().parent.parent
P = gl64.P
F = gl64.Field("cpu")
EDGES = np.array([0, 1, gl64.EPSILON, 2**32, P - 1, P, P + 1, 2**63, 2**64 - 1],
                 dtype=np.uint64)
SMALL_KS = [2, 3, 7, 25, 4097, 2**15 - 1]
PLAIN = {"gl_mul": gl64.mul_plain, "gl_add": gl64.add_plain, "gl_sub": gl64.sub_plain,
         "gl_mul_add": gl64.mul_add_plain}
ARITY = {"gl_mul": 2, "gl_add": 2, "gl_sub": 2, "gl_mul_add": 3}


def _words(rng, shape):
    """Full-range uint64 words, a quarter of them edge words."""
    w = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    pick = rng.random(shape) < 0.25
    w[pick] = rng.choice(EDGES, size=int(pick.sum()))
    return w


def _t(a):
    return gl64.from_u64(a, "cpu")


# ------------------------------------------------------------ the schedule
@pytest.mark.parametrize("name", list(PLAIN))
def test_schedule_equals_plain_word_for_word(name):
    """Every pair (every triple for mul_add) of edge words, and 4,096
    seeded random ones: the schedule's word is the plain version's."""
    rng = np.random.default_rng(10 + FK.KERNELS.index(name))
    k = ARITY[name]
    grid = np.stack(np.meshgrid(*[EDGES] * k, indexing="ij")).reshape(k, -1)
    ops = np.concatenate([grid, _words(rng, (k, 4096))], axis=1)
    want = gl64.to_u64(gl64.canonical(PLAIN[name](*[_t(o) for o in ops])))
    raw = PLAIN[name](*[_t(o) for o in ops]).numpy().view(np.uint64)
    got = [FK.schedule_field_ints(name, *(int(o[i]) for o in ops)) for i in range(ops.shape[1])]
    assert np.array_equal(np.array(got, dtype=np.uint64), raw)
    assert np.array_equal(np.array(got, dtype=np.uint64) % np.uint64(P), want)


@pytest.mark.parametrize("k", SMALL_KS)
def test_mul_small_schedule_equals_fold_of_halves(k):
    """gl_mul_small's 64-bit product folds to the word of the plain
    version's fold of the halves' products, for every edge word."""
    rng = np.random.default_rng(30 + k)
    a = np.concatenate([EDGES, _words(rng, (2048,))])
    raw = gl64.mul_small_plain(_t(a), k).numpy().view(np.uint64)
    got = np.array([FK.schedule_field_ints("gl_mul_small", int(v), k=k) for v in a],
                   dtype=np.uint64)
    assert np.array_equal(got, raw)


# ------------------------------------------------------------ the geometry
def _offsets(geom):
    """Each operand's word offsets for every element of the output, as the
    kernel computes them from the geometry: int64[3, n]."""
    n, rank = geom[0], geom[1]
    shape = geom[2:2 + FK.MAX_RANK]
    strides = [geom[2 + FK.MAX_RANK * (1 + j):2 + FK.MAX_RANK * (2 + j)] for j in range(3)]
    rest = np.arange(n, dtype=np.int64)
    off = np.zeros((3, n), dtype=np.int64)
    for d in reversed(range(rank)):
        at = rest % shape[d]
        rest = rest // shape[d]
        for j in range(3):
            off[j] += at * strides[j][d]
    return off


def _gather(t, off):
    """The words of `t`'s storage at `off` words from its first element."""
    if t is None or not off.size:
        return torch.zeros(off.shape, dtype=torch.int64)
    span = int(off.max()) + 1
    return torch.as_strided(t, (span,), (1,))[torch.from_numpy(off)]


def _emulate(name, operands, k=0):
    """The kernel's output from its geometry: each operand's words gathered
    at the emulated offsets, then the plain version on the flat words."""
    shape, geom = FK.launch_args(*operands)
    off = _offsets(geom)
    words = [_gather(t, off[j]) for j, t in enumerate(operands)]
    if name == "gl_mul_small":
        flat = gl64.mul_small_plain(words[0], k)
    else:
        flat = PLAIN[name](*words)
    return flat.reshape(shape), geom


def _forms(rng):
    """Operand triples of every form the paths give."""
    x = _t(_words(rng, (6, 40)))
    y = _t(_words(rng, (3, 4, 5, 4, 3, 4)))      # sliced in every dim: 6 dims stay 6
    return {
        "equal": tuple(_t(_words(rng, (3, 5, 7))) for _ in range(3)),
        "twiddles": (_t(_words(rng, (4, 6, 16))), _t(_words(rng, (16,))),
                     _t(_words(rng, (6, 1)))),
        "0-dim": (_t(_words(rng, ())), _t(_words(rng, (9,))), _t(_words(rng, ()))),
        "strided": (x[:, 0::2], x[:, 1::2], _t(_words(rng, (6, 60)))[:, ::3]),
        "transposed": (x.T, _t(_words(rng, (40, 6))), x.T[:, :1]),
        "size-1 dims": (_t(_words(rng, (1, 5, 1))), _t(_words(rng, (5, 1))),
                        _t(_words(rng, (1,)))),
        "empty": (_t(_words(rng, (0, 3))), _t(_words(rng, (3,))), _t(_words(rng, (0, 1)))),
        "rank 6": (y[:2, :3, :4, :3, :2, :3], y[1:, 1:, 1:, 1:, 1:, 1:],
                   y[1:, :3, 1:, :3, 1:, :3]),
    }


FORMS = list(_forms(np.random.default_rng(0)))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", list(PLAIN) + ["gl_mul_small", "neg"])
def test_launch_args_reproduce_the_plain_result(name, form):
    """The emulated kernel over `launch_args`' geometry gives the plain
    version's words and shape, and its strides read every operand where
    it lies (no copy)."""
    rng = np.random.default_rng(40 + FORMS.index(form))
    a, b, c = _forms(rng)[form]
    if name == "gl_mul_small":
        for k in (2, 7, 2**15 - 1):
            got, _ = _emulate(name, (a,), k)
            assert torch.equal(got, gl64.mul_small_plain(a, k))
        return
    if name == "neg":
        got, geom = _emulate("gl_sub", (None, c))
        assert torch.equal(got, gl64.sub_plain(torch.zeros_like(c), c))
        assert geom[2 + FK.MAX_RANK:2 + 2 * FK.MAX_RANK] == [0] * FK.MAX_RANK
        return
    ops = (a, b, c)[:ARITY[name]]
    got, geom = _emulate(name, ops)
    want = PLAIN[name](*ops)
    assert got.shape == want.shape and torch.equal(got, want)
    assert 1 <= geom[1] <= FK.MAX_RANK and geom[0] == want.numel()


def test_launch_args_flat_and_collapsed():
    """Equal contiguous shapes take one dim; broadcast and strided ones
    collapse to as few dims as their strides allow."""
    rng = np.random.default_rng(50)
    a, b = _t(_words(rng, (4, 8, 16))), _t(_words(rng, (4, 8, 16)))
    shape, geom = FK.launch_args(a, b)
    assert tuple(shape) == (4, 8, 16) and geom[:3] == [512, 1, 512]
    assert len(geom) == FK.GEOM_WORDS
    _, geom = FK.launch_args(a, _t(_words(rng, (16,))))   # the NTT's twiddles
    assert geom[1] == 2 and geom[2:4] == [32, 16]
    assert geom[2 + FK.MAX_RANK:2 + FK.MAX_RANK + 2] == [16, 1]
    assert geom[2 + 2 * FK.MAX_RANK:2 + 2 * FK.MAX_RANK + 2] == [0, 1]
    x = _t(_words(rng, (6, 40)))
    _, geom = FK.launch_args(x[:, 0::2], x[:, 1::2])       # the prover's halving fold
    assert geom[:3] == [120, 1, 120]
    assert geom[2 + FK.MAX_RANK] == 2 and geom[2 + 2 * FK.MAX_RANK] == 2
    _, geom = FK.launch_args(_t(_words(rng, ())), a)
    assert geom[:3] == [512, 1, 512] and geom[2 + FK.MAX_RANK] == 0


def test_launch_args_refuse_what_no_kernel_takes(card):
    """Shapes that do not broadcast raise ValueError. 8 dims that no merge
    joins (w's size-1 dims keep z's apart) take one launch all the same:
    `fit` makes the operands that keep them apart contiguous, and the
    words are the plain version's."""
    lib, plain = card
    rng = np.random.default_rng(60)
    z = _t(_words(rng, (2, 3, 2, 3, 2, 3, 2, 6)))[..., ::2]
    w = _t(_words(rng, (2, 1, 2, 1, 2, 1, 2, 1)))
    with pytest.raises(ValueError, match="dims after merging"):
        FK.launch_args(z, w)
    # z alone steps through its 8 dims as one (stride 2): only w is copied
    a, b = FK.fit((z, w))
    assert a is z and b.is_contiguous() and b.shape == z.shape
    assert FK.launch_args(a, b)[1][:3] == [z.numel(), 1, z.numel()]
    got = gl64.mul(z, w)
    assert FK.LAUNCHES["gl_mul"] == 1 and len(lib.calls) == 1
    assert torch.equal(got, plain["mul_plain"](z, w))
    # the transposed z keeps its dims apart on its own: it is copied, and
    # the 0-dim operand, which never blocks a merge, is not
    rev = tuple(range(7, -1, -1))
    zt, wt, k = z.permute(rev), w.permute(rev), _t(_words(rng, ()))
    with pytest.raises(ValueError, match="dims after merging"):
        FK.launch_args(zt, wt, k)
    a, b = FK.fit((zt, k))
    assert b is k and a.is_contiguous()
    assert torch.equal(gl64.mul_add(zt, wt, k),
                       plain["add_plain"](plain["mul_plain"](zt, wt), k))
    assert FK.LAUNCHES["gl_mul_add"] == 1 and len(lib.calls) == 2
    assert FK.fit((None, z))[0] is None
    with pytest.raises(ValueError, match="do not broadcast"):
        FK.launch_args(_t(_words(rng, (3, 4))), _t(_words(rng, (5,))))


# ------------------------------------------------------ the zk20 path's calls
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_zk20_path_calls_and_launch_counts(monkeypatch):
    """Every call of the five functions (and neg) on the zk20 verifier's
    CPU path, first 4 proofs of sem_zk20b64.npz, leaving out those inside
    the Poseidon permutation's and the inverses' plain versions (one kernel
    each on a card): each operand form goes through `launch_args` and the
    emulation to the plain result, and the calls a kernel gets equal the
    launches chip_smoke.py pins for a zk20 batch."""
    names = {"mul": "gl_mul", "add": "gl_add", "sub": "gl_sub", "neg": "gl_sub",
             "mul_add": "gl_mul_add", "mul_small": "gl_mul_small"}
    calls, depth = [], [0]

    def wrap(fname, fn, record=True):
        def inner(*args):
            if record and depth[0] == 0 and not (fname == "mul_small" and args[1] < 2):
                calls.append((fname, args))
            depth[0] += 1
            try:
                return fn(*args)
            finally:
                depth[0] -= 1
        return inner

    for fname in names:
        w = wrap(fname, getattr(gl64, fname))
        monkeypatch.setattr(gl64, fname, w)
        monkeypatch.setattr(gl64.Field, fname, staticmethod(w))
    for fname in ("inv", "permute12"):
        w = wrap(fname, getattr(gl64, fname), record=False)
        monkeypatch.setattr(gl64, fname, w)
        monkeypatch.setattr(gl64.Field, fname, staticmethod(w))
    monkeypatch.setattr(ext2, "inv", wrap("ext2.inv", ext2.inv, record=False))

    proofs, common, vk = load_proofs(REPO / "fixtures" / "sem_zk20b64.npz")
    fn, to_device = FS.make_verifier_fn_batched(common, vk, device="cpu")
    assert fn(to_device(FS.batched_arrays(proofs[:4]))).tolist() == [True] * 4

    counts = dict.fromkeys(FK.KERNELS, 0)
    forms = set()
    for fname, args in calls:
        kernel = names[fname]
        counts[kernel] += 1
        if fname == "neg":
            ops, want = (None, args[0]), gl64.sub_plain(torch.zeros_like(args[0]), args[0])
        elif fname == "mul_small":
            ops, want = (args[0],), gl64.mul_small_plain(*args)
        else:
            ops, want = args, getattr(gl64, fname + "_plain")(*args)
        assert FK._device_of(ops) == "cpu"
        got, geom = _emulate(kernel, ops, args[1] if fname == "mul_small" else 0)
        assert got.shape == want.shape and torch.equal(got, want), (fname, geom[:8])
        forms.add((kernel, geom[1]))
    assert counts == _chip_smoke().ZK20_FIELD_LAUNCHES
    assert {r for _, r in forms} >= {1, 2}       # flat and broadcast forms both met


# ------------------------------------------------ against the JAX package
@pytest.mark.parametrize("name", ["mul", "add", "sub", "mul_add", "neg", "square"]
                         + [f"mul_small_{k}" for k in (0, 1, 7, 2**15 - 1)])
def test_equals_gl64_np_after_canonicalisation(name):
    """Canonical words through gl64_np and through the port's functions
    (the plain versions here; the kernels give the same words): equal
    after canonicalisation. 9,000 words: past gl64_np's switch to its C
    plane at 8,192."""
    rng = np.random.default_rng(70 + len(name))
    a, b, c = (rng.integers(0, P, size=9000, dtype=np.uint64) for _ in range(3))
    for arr in (a, b, c):
        arr[:len(EDGES)] = EDGES % np.uint64(P)
    ta, tb, tc = _t(a), _t(b), _t(c)
    if name.startswith("mul_small_"):
        k = int(name.rsplit("_", 1)[1])
        got, want = gl64.mul_small(ta, k), gl.mul_small(a, k)
    else:
        port = {"mul": lambda: gl64.mul(ta, tb), "add": lambda: gl64.add(ta, tb),
                "sub": lambda: gl64.sub(ta, tb), "mul_add": lambda: gl64.mul_add(ta, tb, tc),
                "neg": lambda: gl64.neg(ta), "square": lambda: gl64.square(ta)}
        ref = {"mul": lambda: gl.mul(a, b), "add": lambda: gl.add(a, b),
               "sub": lambda: gl.sub(a, b), "mul_add": lambda: gl.mul_add(a, b, c),
               "neg": lambda: gl.neg(a), "square": lambda: gl.square(a)}
        got, want = port[name](), ref[name]()
    assert np.array_equal(gl64.to_u64(got), np.asarray(want, dtype=np.uint64))


# ------------------------------------------------------------ the dispatch
def _u64(ptr, n):
    return (ctypes.c_uint64 * n).from_address(ptr)


class _FakeFieldLibrary:
    """field_launch as the card runs it: each element's schedule at the
    pointers and the geometry it is given; `fail` returns that CUDA error
    instead."""

    def __init__(self):
        self.calls, self.fail = [], 0

    def field_launch(self, op, a, b, c, out, k, geom, stream):
        g = list((ctypes.c_longlong * FK.GEOM_WORDS).from_address(geom))
        self.calls.append((FK.KERNELS[op], (a, b, c, out, k), g))
        if self.fail:
            return self.fail
        off = _offsets(g)
        dst = _u64(out, g[0])
        ptrs = (a, b, c)
        for i in range(g[0]):
            w = [0 if p is None else _u64(p + 8 * int(off[j, i]), 1)[0]
                 for j, p in enumerate(ptrs)]
            dst[i] = FK.schedule_field_ints(FK.KERNELS[op], *w, k=k)
        return 0


@pytest.fixture
def card(monkeypatch):
    """CPU tensors taken for the card's: gl64 sends them to the wrappers,
    whose device check says "cuda"; the library is the fake; every plain
    version raises; the counts start at 0."""
    lib = _FakeFieldLibrary()

    def refuse(*args, **kw):
        raise AssertionError("a plain version ran for a tensor on the card")

    monkeypatch.setattr(gl64, "_on_card", lambda *ops: True)
    monkeypatch.setattr(FK, "_device_of", lambda ops: "cuda")
    monkeypatch.setattr(FK, "_library", lambda device: lib)
    monkeypatch.setattr(FK, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(FK, "LAUNCHES", dict.fromkeys(FK.KERNELS, 0))
    plain = {name: getattr(gl64, name) for name in
             ("mul_plain", "add_plain", "sub_plain", "mul_add_plain", "mul_small_plain")}
    for name in plain:
        monkeypatch.setattr(gl64, name, refuse)
    return lib, plain


def test_fake_card_every_call_is_one_launch(card):
    """gl64's five functions, neg, square and pow_const on the card: one
    counted launch a call (none for mul_small by 0 or 1), the schedule's
    words at the wrapper's pointers, equal to the plain versions'."""
    lib, plain = card
    rng = np.random.default_rng(80)
    a, b = _t(_words(rng, (3, 4))), _t(_words(rng, (4,)))
    c = _t(_words(rng, ()))
    got = {"mul": gl64.mul(a, b), "add": gl64.add(a, b), "sub": gl64.sub(a, b),
           "mul_add": gl64.mul_add(a, b, c), "mul_small": gl64.mul_small(a, 25),
           "neg": gl64.neg(a), "square": gl64.square(b)}
    assert gl64.mul_small(a, 1) is a
    assert torch.equal(gl64.mul_small(a, 0), torch.zeros_like(a))
    assert [name for name, _, _ in lib.calls] == [
        "gl_mul", "gl_add", "gl_sub", "gl_mul_add", "gl_mul_small", "gl_sub", "gl_mul"]
    assert lib.calls[5][1][0] is None               # neg: the kernel reads 0
    assert lib.calls[4][1][4] == 25
    assert FK.LAUNCHES == {"gl_mul": 2, "gl_add": 1, "gl_sub": 2, "gl_mul_add": 1,
                           "gl_mul_small": 1}
    want = {"mul": plain["mul_plain"](a, b), "add": plain["add_plain"](a, b),
            "sub": plain["sub_plain"](a, b),
            "mul_add": plain["add_plain"](plain["mul_plain"](a, b), c),
            "mul_small": plain["mul_small_plain"](a, 25),
            "neg": plain["sub_plain"](torch.zeros_like(a), a),
            "square": plain["mul_plain"](b, b)}
    for name in got:
        assert torch.equal(got[name], want[name]), name
        assert got[name].is_contiguous()
    x = _t(_words(rng, (5,)))
    assert torch.equal(gl64.pow_const(x, 11), _power(plain["mul_plain"], x, 11))
    assert FK.LAUNCHES["gl_mul"] == 2 + 5           # 3 squarings, 2 products
    assert torch.equal(gl64.Field("cpu").mul(a, b), want["mul"])   # Field follows
    assert FK.LAUNCHES["gl_mul"] == 8


def _power(mul, x, e):
    out = None
    while e:
        if e & 1:
            out = x if out is None else mul(out, x)
        e >>= 1
        if e:
            x = mul(x, x)
    return out


def test_fake_card_strided_operands_read_in_place(card):
    """A strided view and a broadcast 0-dim operand reach the launch as
    their own pointers (no contiguous copy); an empty output launches
    nothing."""
    lib, plain = card
    rng = np.random.default_rng(81)
    x = _t(_words(rng, (4, 10)))
    k = _t(_words(rng, ()))
    got = gl64.add(x[:, 1::2], k)
    (name, (pa, pb, _, _, _), geom), = lib.calls
    assert name == "gl_add" and pa == x[:, 1::2].data_ptr() and pb == k.data_ptr()
    assert geom[:3] == [20, 1, 20] and geom[2 + FK.MAX_RANK] == 2
    assert geom[2 + 2 * FK.MAX_RANK] == 0
    assert torch.equal(got, plain["add_plain"](x[:, 1::2], k))
    empty = gl64.mul(_t(_words(rng, (0, 4))), _t(_words(rng, (4,))))
    assert empty.shape == (0, 4) and len(lib.calls) == 1
    assert FK.LAUNCHES["gl_mul"] == 0


@pytest.mark.parametrize("name", ["mul", "add", "sub", "mul_add", "mul_small", "neg"])
def test_fake_card_failed_launch_raises(card, name):
    """A CUDA error from the launch raises and counts nothing; no plain
    version is tried (they all raise here)."""
    lib, _ = card
    lib.fail = 719
    a = torch.ones((2, 3), dtype=torch.int64)
    calls = {"mul": lambda: gl64.mul(a, a), "add": lambda: gl64.add(a, a),
             "sub": lambda: gl64.sub(a, a), "mul_add": lambda: gl64.mul_add(a, a, a),
             "mul_small": lambda: gl64.mul_small(a, 9), "neg": lambda: gl64.neg(a)}
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        calls[name]()
    assert not any(FK.LAUNCHES.values())


@pytest.mark.parametrize("name", ["mul", "add", "sub", "mul_add", "mul_small", "neg"])
def test_tensor_off_the_cpu_never_takes_the_plain_version(monkeypatch, name):
    """A tensor on a device other than the CPU (here "meta", which has no
    kernel) goes to the wrapper, which raises: no plain version runs."""
    def refuse(*args, **kw):
        raise AssertionError("a plain version ran for a tensor off the CPU")

    for plain in ("mul_plain", "add_plain", "sub_plain", "mul_add_plain", "mul_small_plain"):
        monkeypatch.setattr(gl64, plain, refuse)
    m = torch.zeros((2, 3), dtype=torch.int64, device="meta")
    calls = {"mul": lambda: gl64.mul(m, m), "add": lambda: gl64.add(m, m),
             "sub": lambda: gl64.sub(m, m), "mul_add": lambda: gl64.mul_add(m, m, m),
             "mul_small": lambda: gl64.mul_small(m, 9), "neg": lambda: gl64.neg(m)}
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        calls[name]()


@pytest.mark.parametrize("case", ["int32", "python int", "two devices", "no broadcast",
                                  "k too large"])
def test_wrappers_refuse_bad_operands(case):
    """Another dtype, a python number in place of a tensor, operands on two
    devices, shapes that do not broadcast, and mul_small's k at 2^15 raise
    before any launch."""
    a = torch.zeros((2, 4), dtype=torch.int64)
    meta = torch.zeros((2, 4), dtype=torch.int64, device="meta")
    five = torch.zeros((5,), dtype=torch.int64, device="meta")
    calls = {"int32": (TypeError, lambda: FK.mul(a, a.int())),
             "python int": (TypeError, lambda: FK.add(meta, 5)),
             "two devices": (ValueError, lambda: gl64.sub(a, meta)),
             "no broadcast": (ValueError, lambda: FK._launch("gl_add", (meta, five))),
             "k too large": (ValueError, lambda: FK.mul_small(a, 2**15))}
    error, call = calls[case]
    with pytest.raises(error):
        call()
