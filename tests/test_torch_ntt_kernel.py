"""The NTT plane of ops/csrc/ntt.cu (`ntt_tile`, `ntt_stride`) and its
wrappers in ops/ntt_kernel.py and ops/ntt.py, on the CPU.

The kernels must give the plain versions' own words at every stage
boundary, so every comparison here is exact:

  * the kernels' schedule (`schedule_ntt`: the tile pass, the stride
    passes and the epilogue, index for index, with small tiles so that n
    up to 2^10 takes several passes, and with few stages a stride pass so
    that n up to 2^12 takes three to eleven) against the plain stage loop
    after each pass and at the output, on rows 1, 3 and 7 of edge words
    (0, p - 1, p, p + 1, 2^64 - 1 among them), and on zero-padded inputs,
    whose first stages the tile pass makes as copies;
  * the same outputs, for ntt, intt, coset_fft, coset_ifft and coset_lde
    (rates 2 and 3, shift 7), against the JAX package's numpy NTT and its
    JAX NTT (n <= 64);
  * the launch geometry: every tile and every column of every stride pass
    in exactly one block (one thread), tiles within the shared memory a
    block has, the stride passes' stage ranges covering the stages above
    the tile once each, at any size (2^25 and 2^26 points among them);
  * the dispatch: a tensor off the CPU reaches the launcher (a fake library
    that runs the schedule's passes at the pointers it is given), one launch
    up to 2^t points and one more a stage range above, and never a plain
    version; a failed launch raises; a CPU tensor takes the plain version;
    a length that is not a power of two, or tiles outside 1..MAX_TILE_BITS,
    raise;
  * one prove of the Semaphore circuit (2^20 members, B = 2): its
    transforms' sizes, the NTT launches they make and the field launches
    left outside them, against the pins chip_smoke.py checks on the card.
"""
import ctypes
import importlib.util
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch

from stark_verifier_tpu import native as N
from stark_verifier_tpu.ops import gl64_jax as gj
from stark_verifier_tpu.ops import ntt_jax as rj
from stark_verifier_tpu.ops import ntt_np as rn
from stark_verifier_tpu_torch.core import gates as G
from stark_verifier_tpu_torch.ops import ext2, gl64, ntt
from stark_verifier_tpu_torch.ops import ntt_kernel as NK
from stark_verifier_tpu_torch.ops import poseidon_kernel as PK
from stark_verifier_tpu_torch.ops import witness_kernel as WK
from stark_verifier_tpu_torch.prover import prove as PV
from stark_verifier_tpu_torch.semaphore import access_set as AS

REPO = Path(__file__).resolve().parent.parent
P = gl64.P
EDGES = np.array([0, 1, P - 1, P, P + 1, 2**32 - 1, 2**63, 2**64 - 1], dtype=np.uint64)
SHIFT = 7


def _words(rng, shape):
    """Full-range words, the edge words first in every row."""
    w = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    k = min(len(EDGES), shape[-1])
    w[..., :k] = EDGES[:k]
    return gl64.from_u64(w, "cpu")


def _canonical(rng, shape):
    """Canonical words with 0 and p - 1 first in every row (the
    reference's input form)."""
    w = rng.integers(0, P, size=shape, dtype=np.uint64)
    w[..., 0] = 0
    if shape[-1] > 1:
        w[..., 1] = P - 1
    return w


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ the schedule
# (log2 n, tile bits): one pass (n <= 2^t) and two, up to 2^10
SCHEDULE_CASES = [(0, 1), (1, 1), (2, 1), (3, 2), (5, 3), (6, 3), (4, 4), (7, 4), (8, 4),
                  (10, 5), (10, 6), (9, 12)]


@pytest.mark.parametrize("rows", [1, 3, 7])
@pytest.mark.parametrize("bits,t", SCHEDULE_CASES)
def test_schedule_equals_plain_stage_loop_after_every_pass(bits, t, rows):
    """The tile pass equals the plain loop's words after stage tb - 1, each
    stride pass after its last stage, the output ntt_plain's, word for
    word."""
    x = _words(np.random.default_rng(100 * bits + 10 * t + rows), (rows, 1 << bits))
    after, out = NK.schedule_ntt(x, t)
    g = NK.geometry(bits, rows, t)
    assert len(after) == g["passes"] == (1 if bits <= t else 2)
    ends = [g["tb"]] + [p["s0"] + p["stages"] for p in g["stride"]]
    for words, end in zip(after, ends):
        assert torch.equal(words, ntt.ntt_stages_plain(x, end))
    assert ends[-1] == bits
    assert torch.equal(out, ntt.ntt_plain(x))


# (log2 n, tile bits, stages a stride pass at most): three passes and more,
# up to twelve
MANY_PASS_CASES = [(6, 2, 2), (8, 3, 2), (9, 2, 3), (10, 4, 1), (12, 4, 3), (12, 2, 5),
                   (11, 3, 2)]


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("bits,t,most", MANY_PASS_CASES)
def test_schedule_of_three_passes_and_more_equals_plain_stage_loop(monkeypatch, bits, t, most,
                                                                   rows):
    """With MAX_PASS_STAGES set small, the stride passes cut the stages
    above the tile into ranges of at most that many, the longer first, each
    starting where the last ended; the words after every pass are the
    plain loop's at that stage boundary, and the output ntt_plain's."""
    monkeypatch.setattr(NK, "MAX_PASS_STAGES", most)
    x = _words(np.random.default_rng(1000 * bits + 10 * t + rows), (rows, 1 << bits))
    g = NK.geometry(bits, rows, t)
    stages = [p["stages"] for p in g["stride"]]
    assert len(stages) == -(-(bits - t) // most) >= 2 and g["passes"] >= 3
    assert max(stages) <= most and stages == sorted(stages, reverse=True)
    assert max(stages) - min(stages) <= 1
    after, out = NK.schedule_ntt(x, t)
    assert len(after) == g["passes"]
    end = t
    assert torch.equal(after[0], ntt.ntt_stages_plain(x, t))
    for words, p in zip(after[1:], g["stride"]):
        assert p["s0"] == end
        end += p["stages"]
        assert torch.equal(words, ntt.ntt_stages_plain(x, end))
    assert end == bits
    assert torch.equal(out, ntt.ntt_plain(x))


# (log2 n_out, tile bits, rate): the LDE's copied stages inside one tile,
# all of a tile's stages copies, and two passes
COPY_CASES = [(3, 3, 1), (4, 4, 3), (2, 1, 2), (6, 3, 2), (6, 3, 3), (9, 5, 3), (10, 5, 1)]


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("bits,t,rate", COPY_CASES)
def test_schedule_of_zero_padded_input_copies_its_first_stages(bits, t, rate, rows):
    """n_out / 2^rate words padded with 0: the tile pass loads each word
    into its 2^c slots (c = copy_stages) and starts at stage c, and still
    equals the plain loop on the padded input after each pass."""
    tb = min(t, bits)
    assert NK.copy_stages(1 << (bits - rate), bits, tb) == min(rate, tb)
    assert NK.copy_stages(1 << bits, bits, tb) == 0
    x = _words(np.random.default_rng(1000 * bits + 10 * t + rate), (rows, 1 << (bits - rate)))
    padded = torch.zeros((rows, 1 << bits), dtype=torch.int64)
    padded[:, :x.shape[-1]] = x
    after, out = NK.schedule_ntt(x, t, n_out=1 << bits)
    assert torch.equal(after[0], ntt.ntt_stages_plain(padded, tb))
    assert torch.equal(after[-1], ntt.ntt_stages_plain(padded, bits))
    assert torch.equal(out, ntt.ntt_plain(padded))


SCHEDULE_FUNCTIONS = {
    "ntt": ((), ntt.ntt_plain), "intt": ((), ntt.intt_plain),
    "coset_fft": ((SHIFT,), ntt.coset_fft_plain), "coset_ifft": ((SHIFT,), ntt.coset_ifft_plain),
    "coset_lde_r2": ((2, SHIFT), ntt.coset_lde_plain),
    "coset_lde_r3": ((3, SHIFT), ntt.coset_lde_plain)}


def _schedule(name, x, t, *args):
    """The kernels' schedule of transform `name` on [R, n] rows: the
    arguments ops/ntt.py gives the launch."""
    kw = getattr(ntt, name.split("_r")[0] + "_kernel_args")(x, *args)
    return NK.schedule_ntt(x, t, **kw)[1]


@pytest.mark.parametrize("bits,t", [(3, 2), (6, 3), (10, 5)])
@pytest.mark.parametrize("name", SCHEDULE_FUNCTIONS)
def test_schedule_of_each_function_equals_plain(name, bits, t):
    """Every function's front and epilogue through the schedule, on edge
    words, two passes where 2^t is below the output length."""
    args, plain = SCHEDULE_FUNCTIONS[name]
    x = _words(np.random.default_rng(7 * bits + len(name)), (3, 1 << bits))
    assert torch.equal(_schedule(name, x, t, *args), plain(x, *args))


def _jax_coset_ifft(x, shift):
    """The JAX package has no JAX coset_ifft: its intt, then coefficient i
    times shift^-i in its JAX field."""
    n = x.shape[-1]
    inv = pow(shift, P - 2, P)
    powers = np.array([pow(inv, i, P) for i in range(n)], dtype=np.uint64)
    return gj.mul(rj.intt(x), gj.from_u64(powers))


REFERENCE = {"ntt": (rn.ntt, rj.ntt), "intt": (rn.intt, rj.intt),
             "coset_fft": (rn.coset_fft, rj.coset_fft),
             "coset_ifft": (rn.coset_ifft, _jax_coset_ifft),
             "coset_lde_r2": (rn.coset_lde, rj.coset_lde),
             "coset_lde_r3": (rn.coset_lde, rj.coset_lde)}


def _reference_case(name, n):
    """(schedule's output, canonical input) at n input points, with tiles
    that make two passes."""
    args, _ = SCHEDULE_FUNCTIONS[name]
    x = _canonical(np.random.default_rng(n + len(name)), (2, n))
    out_bits = n.bit_length() - 1 + (args[0] if name.startswith("coset_lde") else 0)
    t = (out_bits + 1) // 2
    return gl64.to_u64(_schedule(name, gl64.from_u64(x, "cpu"), t, *args)), x, args


@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("name", SCHEDULE_FUNCTIONS)
def test_schedule_equals_jax_package_numpy(name, n):
    """The schedule's output against the JAX package's numpy NTT."""
    got, x, args = _reference_case(name, n)
    assert np.array_equal(got, np.asarray(REFERENCE[name][0](x, *args), dtype=np.uint64))


# the LDEs at n = 8 (each new shape is a compile), the transforms at 64
JAX_N = {name: 8 if name.startswith("coset_lde") else 64 for name in SCHEDULE_FUNCTIONS}


@pytest.mark.parametrize("name", SCHEDULE_FUNCTIONS)
def test_schedule_equals_jax_package_jax(name):
    """The schedule's output against the JAX package's JAX NTT."""
    got, x, args = _reference_case(name, JAX_N[name])
    want = np.asarray(gj.to_u64(REFERENCE[name][1](gj.from_u64(x), *args)), dtype=np.uint64)
    assert np.array_equal(got, want)


# ------------------------------------------------------------ the geometry
def _stride_columns(bits, rows, p):
    """[(rows, first positions)] of the columns the threads of one stride
    pass take, one entry a row of a thread's run, as ntt_stride_kernel
    divides its grid: block b is column block b mod col_blocks of row
    chunk b // col_blocks."""
    L, s0 = p["stages"], p["s0"]
    threads, cols = 1 << p["log_threads"], 1 << (bits - L)
    col_blocks = -(-cols // threads)
    assert p["blocks"] == col_blocks * -(-rows // p["rows_a_thread"])
    b = np.arange(p["blocks"])[:, None]
    c = (b % col_blocks) * threads + np.arange(threads)[None, :]
    row0 = np.broadcast_to((b // col_blocks) * p["rows_a_thread"], c.shape)
    live = c < cols
    c, row0 = c[live], row0[live]
    at = ((c >> s0) << (s0 + L)) + (c & ((1 << s0) - 1))
    runs = [row0 + i for i in range(p["rows_a_thread"])]
    return [(r[r < rows], at[r < rows]) for r in runs]


@pytest.mark.parametrize("bits,rows,t", [(1, 1, 12), (9, 8640, 12), (12, 64, 12),
                                         (13, 2160, 12), (16, 16, 12), (16, 1080, 11),
                                         (17, 2, 12), (17, 3, 13), (22, 1, 11), (24, 1, 12),
                                         (18, 5, 12), (20, 3, 4), (25, 1, 12), (26, 1, 12),
                                         (13, 300, 12), (13, 129, 12)])
def test_geometry_covers_every_tile_and_column_once(bits, rows, t):
    """Each ntt_tile block's tiles (2^log_group of them, neighbours in
    rev(k), or whole rows): every one exactly once, within SMEM_WORDS, the
    tiles of a block in one row where a row has several. The stride passes:
    stages tb .. bits - 1 once each, at most MAX_PASS_STAGES a launch;
    every position of every row in exactly one thread's column, a column
    its 2^L positions 2^s0 apart; 32 to 256 threads a block, at most
    STRIDE_ROWS rows a thread."""
    g = NK.geometry(bits, rows, t)
    tb, sbits = g["tb"], bits - g["tb"]
    tiles = rows << sbits
    assert g["tile_blocks"] == -(-tiles >> g["log_group"])
    assert (1 << (tb + g["log_group"])) <= NK.SMEM_WORDS
    assert g["passes"] == 1 + len(g["stride"]) == 1 + -(-sbits // NK.MAX_PASS_STAGES)
    if sbits:
        assert g["log_group"] <= sbits       # a block's tiles lie in one row
    if g["tile_blocks"] <= 4096:
        seen = np.zeros(tiles, dtype=np.int64)
        for b in range(g["tile_blocks"]):
            u0 = b << g["log_group"]
            seen[u0:min(u0 + (1 << g["log_group"]), tiles)] += 1
        assert (seen == 1).all()
    end = tb
    for p in g["stride"]:
        assert p["s0"] == end and 1 <= p["stages"] <= NK.MAX_PASS_STAGES
        end += p["stages"]
        assert 5 <= p["log_threads"] <= NK.STRIDE_LOG_THREADS
        assert 1 <= p["rows_a_thread"] <= min(NK.STRIDE_ROWS, rows)
        assert p["blocks"] < 2**31
        if rows << bits <= 1 << 22:
            seen = np.zeros((rows, 1 << bits), dtype=np.int8)
            for r, at in _stride_columns(bits, rows, p):
                for q in range(1 << p["stages"]):
                    np.add.at(seen, (r, at + (q << p["s0"])), 1)
            assert (seen == 1).all()
    assert end == bits
    # every provers' transform up to 2^17 points: one stride pass at most
    if bits <= 17 and t == NK.TILE_BITS:
        assert g["passes"] == 1 + (bits > t)


@pytest.mark.parametrize("bits,t", [(5, 2), (23, 11), (25, 12), (27, 13), (40, 12)])
def test_beyond_two_passes_the_stride_passes_take_the_rest(bits, t):
    """Where two passes of 2^t do not cover 2^bits points (ntt_stride took
    at most t stages before), the stride passes take the rest, a range of
    at most MAX_PASS_STAGES stages each: no size raises."""
    assert bits > 2 * t
    g = NK.geometry(bits, 1, t)
    assert [p["s0"] for p in g["stride"]][0] == t
    assert sum(p["stages"] for p in g["stride"]) == bits - t
    assert len(g["stride"]) == -(-(bits - t) // NK.MAX_PASS_STAGES) == g["passes"] - 1


@pytest.mark.parametrize("t", [0, NK.MAX_TILE_BITS + 1])
def test_tile_bits_outside_range_raise(t):
    with pytest.raises(ValueError, match="tile bits"):
        NK.geometry(20, 1, t)


# ------------------------------------------------------------ the dispatch
def _u64(ptr, n):
    return np.ctypeslib.as_array((ctypes.c_int64 * n).from_address(ptr))


class _FakeNttLibrary:
    """ntt_tile and ntt_stride as the card runs them: the schedule's passes
    on the words at the pointers, strides and geometry they are given;
    `fail` returns that CUDA error instead."""

    def __init__(self):
        self.calls, self.fail = [], 0

    def _tables(self, tw, bits):
        return torch.from_numpy(_u64(tw, max((1 << bits) - 1, 1)).copy())

    def _store(self, out, v, epi, n_inv, ip, rows, n):
        if epi != NK.NONE:
            inv = None if not ip else torch.from_numpy(_u64(ip, n).copy())
            v = NK.epilogue_pass(v, epi, n_inv, inv)
        _u64(out, rows * n)[:] = v.reshape(-1).numpy()

    def ntt_tile(self, x, rs, es, n_in, out, tw, pw, ip, n_inv, bits, tb, lg, rows, epi,
                 stream):
        self.calls.append(("ntt_tile", x, rs, es, n_in, bits, tb, lg, rows, epi))
        if self.fail:
            return self.fail
        assert NK.geometry(bits, rows, max(tb, 1))["log_group"] == lg
        span = (rows - 1) * rs + (n_in - 1) * es + 1
        flat = _u64(x, span)
        idx = np.arange(rows)[:, None] * rs + np.arange(n_in)[None, :] * es
        xr = torch.from_numpy(flat[idx].copy())
        powers = None if not pw else torch.from_numpy(_u64(pw, n_in).copy())
        v = NK.tile_pass(xr, 1 << bits, self._tables(tw, bits), max(tb, 1), powers)
        self._store(out, v, epi, n_inv, ip, rows, 1 << bits)
        return 0

    def ntt_stride(self, mid, out, tw, ip, n_inv, bits, s0, stages, log_threads,
                   rows_a_thread, rows, epi, stream):
        self.calls.append(("ntt_stride", mid, out, bits, s0, stages, rows, epi))
        if self.fail:
            return self.fail
        p = {"s0": s0, "stages": stages, "log_threads": log_threads,
             "rows_a_thread": rows_a_thread}
        assert p.items() <= next(q for q in NK.geometry(bits, rows)["stride"]
                                 if q["s0"] == s0).items()
        n = 1 << bits
        v = torch.from_numpy(_u64(mid, rows * n).copy()).reshape(rows, n)
        self._store(out, NK.stride_pass(v, self._tables(tw, bits), s0, stages), epi, n_inv,
                    ip, rows, n)
        return 0


PLAIN = ("ntt_plain", "intt_plain", "coset_fft_plain", "coset_ifft_plain", "coset_lde_plain")


@pytest.fixture
def card(monkeypatch):
    """CPU tensors taken for the card's: ops/ntt.py sends them to the
    launcher, whose device check says "cuda"; the library is the fake, with
    tiles of 2^3 and at most 2 stages a stride pass; every plain version
    raises, except through the returned `plain` (the expected words); the
    counts start at 0."""
    lib = _FakeNttLibrary()
    armed = [True]
    originals = {name: getattr(ntt, name) for name in PLAIN}

    def refusing(name):
        def refuse(*args, **kw):
            if armed[0]:
                raise AssertionError("a plain version ran for a tensor on the card")
            return originals[name](*args, **kw)
        return refuse

    def expected(name):
        def call(*args):
            armed[0] = False
            try:
                return originals[name](*args)
            finally:
                armed[0] = True
        return call

    monkeypatch.setattr(ntt, "_on_card", lambda x: True)
    monkeypatch.setattr(NK, "_device_of", lambda x: "cuda")
    monkeypatch.setattr(NK, "_library", lambda device: lib)
    monkeypatch.setattr(NK, "_stream", lambda device: 0)
    monkeypatch.setattr(NK, "_on", lambda device: nullcontext())
    monkeypatch.setattr(NK, "TILE_BITS", 3)
    monkeypatch.setattr(NK, "MAX_PASS_STAGES", 2)
    monkeypatch.setattr(NK, "LAUNCHES", dict.fromkeys(NK.KERNELS, 0))
    for name in PLAIN:
        monkeypatch.setattr(ntt, name, refusing(name))
    return lib, {name: expected(name) for name in PLAIN}


CARD_CALLS = [("ntt", ()), ("intt", ()), ("coset_fft", (SHIFT,)), ("coset_ifft", (SHIFT,)),
              ("coset_lde", (2, SHIFT)), ("coset_lde", (3, SHIFT))]
# every function at 2^0 .. 2^8 input points with at most 2^9 output points:
# one launch, two, three, and four (2^8, 2^9: three stride passes)
CARD_CASES = [(name, args, bits) for name, args in CARD_CALLS for bits in (0, 1, 3, 4, 6, 8)
              if bits + (args[0] if name == "coset_lde" else 0) <= 9]


@pytest.mark.parametrize("name,args,bits", CARD_CASES, ids=str)
def test_fake_card_one_or_two_launches_a_transform(card, name, args, bits):
    """Each function on the card: ntt_tile alone up to 2^3 output points,
    then one ntt_stride for each range of at most 2 stages above, the
    epilogue in the last; the words the plain version gives; nothing else
    launched."""
    lib, plain = card
    n_out = (1 << bits) << (args[0] if name == "coset_lde" else 0)
    x = _words(np.random.default_rng(bits + len(name)), (2, 3, 1 << bits))
    got = getattr(ntt, name)(x, *args)
    strides = -(-max(n_out.bit_length() - 1 - 3, 0) // 2)
    assert [c[0] for c in lib.calls] == ["ntt_tile"] + ["ntt_stride"] * strides
    assert NK.LAUNCHES == {"ntt_tile": 1, "ntt_stride": strides}
    assert [c[-1] for c in lib.calls] == [NK.NONE] * strides + [
        NK.FORWARD if name in ("ntt", "coset_fft", "coset_lde") else
        NK.INVERSE if name == "intt" else NK.INVERSE_COSET]
    if strides:                                 # an inverse's passes: in place on a buffer
        mids = {c[1] for c in lib.calls[1:]}
        outs = [c[2] for c in lib.calls[1:]]
        assert len(mids) == 1 and outs[:-1] == [lib.calls[1][1]] * (strides - 1)
        assert (outs[-1] == got.data_ptr()) and (
            (outs[-1] in mids) == (name not in ("intt", "coset_ifft")))
    assert got.shape == (2, 3, n_out) and got.is_contiguous()
    assert torch.equal(got, plain[name + "_plain"](x, *args))


def test_fake_card_strided_rows_read_in_place(card):
    """The FRI fold's coefficients (a strided view) reach the launch at
    their own pointer and strides: no copy."""
    lib, plain = card
    base = _words(np.random.default_rng(3), (4, 16, 2))
    x = base[:, :, 1]
    got = ntt.coset_fft(x, SHIFT)
    (_, ptr, rs, es, n_in, *_), _ = lib.calls
    assert (ptr, rs, es, n_in) == (x.data_ptr(), 32, 2, 16)
    assert torch.equal(got, plain["coset_fft_plain"](x, SHIFT))


def test_fake_card_ntt_4step_local_transform_launches(card, monkeypatch):
    """ntt_4step's local row transform goes through ntt: on a one-rank
    world of its own (gloo), one launch, equal to the plain NTT."""
    import torch.distributed as dist
    from stark_verifier_tpu_torch.parallel.mesh import make_mesh

    lib, plain = card
    store = Path(__import__("tempfile").mkdtemp()) / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0)
    try:
        x = _words(np.random.default_rng(4), (3, 8))
        got = ntt.ntt_4step(x, make_mesh(axis="ntt"), "ntt")
    finally:
        dist.destroy_process_group()
    assert NK.LAUNCHES == {"ntt_tile": 1, "ntt_stride": 0}
    assert torch.equal(got, plain["ntt_plain"](x))


@pytest.mark.parametrize("name,args", CARD_CALLS[:5], ids=lambda c: str(c))
def test_fake_card_failed_launch_raises(card, name, args):
    """A CUDA error from the launch raises and counts nothing; no plain
    version is tried (they all raise here)."""
    lib, _ = card
    lib.fail = 719
    x = _words(np.random.default_rng(5), (2, 16))
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        getattr(ntt, name)(x, *args)
    assert not any(NK.LAUNCHES.values())


@pytest.mark.parametrize("name,args", CARD_CALLS[:5], ids=lambda c: str(c))
def test_tensor_off_the_cpu_never_takes_the_plain_version(monkeypatch, name, args):
    """A tensor on a device other than the CPU (here "meta", which has no
    kernel) goes to the launcher, which raises: no plain version runs."""
    def refuse(*a, **kw):
        raise AssertionError("a plain version ran for a tensor off the CPU")

    for plain in PLAIN:
        monkeypatch.setattr(ntt, plain, refuse)
    m = torch.zeros((2, 16), dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        getattr(ntt, name)(m, *args)


@pytest.mark.parametrize("name,args", CARD_CALLS[:5], ids=lambda c: str(c))
def test_cpu_tensor_takes_the_plain_version(monkeypatch, name, args):
    """On a CPU tensor the five functions are their plain versions: the
    launcher is never reached."""
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor reached the launcher")

    monkeypatch.setattr(NK, "plan", refuse)
    x = _words(np.random.default_rng(6), (2, 16))
    assert torch.equal(getattr(ntt, name)(x, *args),
                       getattr(ntt, name + "_plain")(x, *args))


def test_launcher_refuses_what_no_kernel_takes(card, monkeypatch):
    """A length that is not a power of two, and tiles outside
    1..MAX_TILE_BITS, raise before any launch."""
    lib, _ = card
    with pytest.raises(ValueError, match="power of two"):
        ntt.ntt(torch.zeros((2, 12), dtype=torch.int64))
    monkeypatch.setattr(NK, "TILE_BITS", NK.MAX_TILE_BITS + 1)
    with pytest.raises(ValueError, match="tile bits"):
        ntt.ntt(torch.zeros((1, 1 << 7), dtype=torch.int64))
    with pytest.raises(ValueError, match="tile bits"):
        ntt.coset_lde(torch.zeros((1, 1 << 5), dtype=torch.int64), 2, SHIFT)
    assert not lib.calls and not any(NK.LAUNCHES.values())


def test_launcher_refuses_another_dtype():
    with pytest.raises(TypeError, match="int64"):
        ntt.ntt(torch.zeros((2, 8), dtype=torch.int32, device="meta"))


# --------------------------------------------- one prove's launches, pinned
KERNEL_PLAIN = [(gl64, "inv"), (gl64, "permute12"), (ext2, "inv"), (PK, "permute_plain"),
                (G, "_poseidon_eval_base")] + [
    (WK, name) for name in ("poseidon_gate_fill", "ext2_reduce_chain", "ext2_arith", "gl_inv",
                            "ext2_inv", "poseidon_gate_eval")]
FIELD = {"mul": "gl_mul", "add": "gl_add", "sub": "gl_sub", "neg": "gl_sub",
         "mul_add": "gl_mul_add", "mul_small": "gl_mul_small"}


def _native_permute(F_, state):
    """The permutation through the JAX package's C plane: the plain one is
    left out of the count anyway, and costs most of a CPU prove."""
    out = N.permute12_np(gl64.to_u64(state))
    return torch.from_numpy(np.ascontiguousarray(out).view(np.int64)).reshape(state.shape)


def _flat(ts):
    """The targets of a target, a list of them, or a list of lists."""
    if not isinstance(ts, list):
        return [ts]
    return [t for x in ts for t in _flat(x)]


def test_prove_launches_pinned(monkeypatch):
    """One prove of the Semaphore circuit (2^20 members, degree 2^9, B = 2;
    random inputs, no witness check) on the CPU: the field calls outside the
    functions that are one kernel each on a card (the permutation, the
    inverses, the witness kernels' plain versions, the quotient's
    PoseidonGate evaluation, and the NTT) equal the field launches
    chip_smoke.py pins for the 64-signal prove (the calls do not depend on
    B); the transforms' output sizes equal its PROVE_NTT_BITS, and the NTT
    launches they make equal its pin."""
    counts, sizes, depth = dict.fromkeys(FIELD.values(), 0), [], [0]

    def wrap(fn, field=None, size=False):
        def inner(*args, **kw):
            if depth[0] == 0:
                if field and not (field == "mul_small" and args[1] < 2):
                    counts[FIELD[field]] += 1
                if size:
                    sizes.append(args)
            depth[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
        return inner

    for fname in FIELD:
        w = wrap(getattr(gl64, fname), field=fname)
        monkeypatch.setattr(gl64, fname, w)
        monkeypatch.setattr(gl64.Field, fname, staticmethod(w))
    for mod, fname in KERNEL_PLAIN:
        w = wrap(getattr(mod, fname))
        monkeypatch.setattr(mod, fname, w)
        if mod is gl64:
            monkeypatch.setattr(gl64.Field, fname, staticmethod(w))
    calls = []
    for fname in ("ntt", "intt", "coset_fft", "coset_ifft", "coset_lde"):
        fn = getattr(ntt, fname)
        monkeypatch.setattr(ntt, fname, wrap(
            lambda x, *a, fn=fn, fname=fname: calls.append((fname, x.shape, a)) or fn(x, *a)))

    data, targets = AS.build_semaphore_circuit(AS.semaphore_config(), 20, device="cpu")
    assert data.common.degree_bits == 9
    rng = np.random.default_rng(12)
    B = 2
    inputs = {}
    for key, ts in targets.items():
        for t in _flat(ts):
            hi = 2 if key == "index" else P
            inputs[t] = rng.integers(0, hi, size=B, dtype=np.uint64)
    for k in counts:
        counts[k] = 0
    calls.clear()
    PV.prove_batch(data, inputs, B, device="cpu", check_witness=False, permute=_native_permute,
                   inner_permute=_native_permute, witness_rng=np.random.default_rng(1),
                   salt_rng=np.random.default_rng(2))
    cs = _chip_smoke()
    assert counts == cs.PROVE_FIELD_LAUNCHES
    out_bits = [int(np.log2(shape[-1])) + (a[0] if f == "coset_lde" else 0)
                for f, shape, a in calls]
    assert out_bits == cs.PROVE_NTT_BITS
    launches = {"ntt_tile": 0, "ntt_stride": 0}
    for bits, (_, shape, _) in zip(out_bits, calls):
        g = NK.geometry(bits, int(np.prod(shape[:-1])))
        launches["ntt_tile"] += 1
        launches["ntt_stride"] += len(g["stride"])
    assert launches == cs.ntt_launches(cs.PROVE_NTT_BITS)
    assert launches["ntt_tile"] == len(cs.PROVE_NTT_BITS) == 17
