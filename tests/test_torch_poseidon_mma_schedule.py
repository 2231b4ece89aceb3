"""The tensor-core Goldilocks Poseidon kernels' schedule on the CPU
(ops/poseidon_kernel: schedule_permute_mma_ints, threads_per_permutation,
the launch wrapper). csrc/poseidon_gl_mma.cu has two grids for each of
poseidon_permute_mma and poseidon_permute_mma2: a narrow one, in which a
warp carries a permutation (poseidon_permute_mma) or two streams packed
(poseidon_permute_mma2) and one mma is a lane's whole MDS layer (its state
passed between the threads by shuffles), and a wide one, in which a
thread owns a permutation and 8 mma a group of 8 lanes and byte index give
each thread the byte sums of the rows it folds. The host model runs each
grid's order of operations on python ints: the A fragments as the kernel
forms them, the m16n8k16 fragment layouts, the shuffles, the pairs of byte
sums, the quad's exchange and the fold, asserting the value bounds the
kernels rely on. Here it is held against `permute_plain(mxu=1)`, the JAX
package's numpy golden model and plonky2's published vectors, on full-range
states with every edge value in every position. Exact equality."""
import ctypes
import re
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from stark_verifier_tpu.ops import gl64_np
from stark_verifier_tpu_torch.ops import _poseidon_gl_constants as tconst
from stark_verifier_tpu_torch.ops import gl64
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk
from test_external_anchor import PLONKY2_TEST_VECTORS_12

P = gl64.P
EDGES = [0, 1, P - 1, P, P + 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1]
SOURCE = Path(pk.__file__).resolve().parent / "csrc" / "poseidon_gl_mma.cu"


def _states():
    """uint64[12, n]: seeded full-range words, then every edge value in every
    position (one lane an edge value and a position, a second edge value
    beside it), then each edge value in all twelve positions at once."""
    rng = np.random.default_rng(66)
    rand = rng.integers(0, 2**64, size=(12, 6), dtype=np.uint64)
    edge_lanes = []
    for pos in range(12):
        for k, e in enumerate(EDGES):
            lane = rng.integers(0, 2**64, size=12, dtype=np.uint64)
            lane[pos] = e
            lane[(pos + 1 + k) % 12] = EDGES[(k + 5) % len(EDGES)]
            edge_lanes.append(lane)
    uniform = [np.full(12, e, dtype=np.uint64) for e in EDGES]
    return np.concatenate([rand, np.stack(edge_lanes + uniform, axis=1)], axis=1)


STATES = _states()


@pytest.fixture(scope="module")
def reference():
    plain = gl64.to_u64(pk.permute_plain(gl64.from_u64(STATES, "cpu"), 1))
    assert (plain == gl64_np.permute12(STATES % np.uint64(P))).all()
    return plain


@pytest.mark.parametrize("layout", pk.MMA_LAYOUTS)
@pytest.mark.parametrize("part", range(6))
def test_schedule_equals_plain_and_golden(reference, layout, part):
    """Every state, in six parts, through each grid's schedule, each state
    at another position of the warp: in the wide grid even and odd groups of
    8 lanes fold rows 8..11 in different threads, in the packed narrow grid
    the two streams' words are held by different threads."""
    for lane in range(part, STATES.shape[1], 6):
        got = pk.schedule_permute_mma_ints(STATES[:, lane].tolist(), layout, lane % 32)
        assert got == [int(v) for v in reference[:, lane]], lane


@pytest.mark.parametrize("ins,expected", PLONKY2_TEST_VECTORS_12)
@pytest.mark.parametrize("layout,lane", [("narrow", 0), ("narrow2", 0), ("narrow2", 1),
                                         ("wide", 3), ("wide", 13)])
def test_schedule_plonky2_published_vectors(layout, lane, ins, expected):
    assert pk.schedule_permute_mma_ints(ins, layout, lane) == expected


def test_kernel_source_declares_what_the_model_uses():
    src = SOURCE.read_text()
    m = re.search(r"#define MDS_CIRC \{([^}]*)\}", src)
    assert m and tuple(int(v) for v in m.group(1).split(",")) == pk._CIRC
    assert re.search(r"constexpr u32 DIAG0 = 8;", src)
    assert re.search(r"#define PARTIAL_AT \(N_ROUNDS \* WIDTH\)", src)
    assert re.search(r"#define TABLE_WORDS \(PARTIAL_AT \+ WIDTH \+ N_PARTIAL\)", src)
    assert re.search(r"^__device__ u64 TABLES\[TABLE_WORDS\];", src, re.M)
    m = re.search(r"^#define WARP (\d+)", src, re.M)
    assert m and int(m.group(1)) == pk.WARP
    # the instruction's types: unsigned bytes in, 32-bit sums out
    assert re.findall(r'"mma\.sync[^"]*"', src) == [
        '"mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "']


def test_a_fragments_form_the_mds_matrix():
    """The narrow grid's A and the wide grid's even A are the MDS matrix in
    rows 0..11; the odd A has rows 8..11 at positions 12..15 and zeros at
    8..11; columns 12..15 are zero in both."""
    mds = gl64._mds12_matrix().tolist()
    even, odd = pk._WIDE_A["even"], pk._WIDE_A["odd"]
    assert [row[:12] for row in even[:12]] == mds
    assert [row[:12] for row in odd[:8]] == mds[:8]
    assert [row[:12] for row in odd[12:]] == mds[8:]
    assert all(v == 0 for row in odd[8:12] for v in row)
    assert all(v == 0 for row in even[12:] for v in row)
    assert all(row[12:] == [0] * 4 for row in even + odd)
    for t, n in enumerate(pk._NARROW):
        g, q = t >> 2, t & 3
        assert (n.a0, n.a1) == (pk._mds_bytes(g, q), pk._mds_bytes(g + 8, q))


def test_narrow_roles_cover_every_word():
    """Each word is held by its quad's threads (two or four of them), and
    every B fragment gathers the four words it needs: with one stream from
    a holder that gives the half its byte lies in (the odd one gives the
    high half), with two packed from the holder of the stream's word."""
    holders = {}
    for t, n in enumerate(pk._NARROW):
        holders.setdefault(n.word, []).append(t)
    assert sorted(holders) == list(range(12))
    assert all(len(h) in (2, 4) for h in holders.values())
    # packed: each (stream, word) has a holder, in quads 0..3 exactly one
    assert {(int(n.odd), n.word) for n in pk._NARROW} == {
        (x, w) for x in (0, 1) for w in range(12)}
    for t, n in enumerate(pk._NARROW):
        g, q = t >> 2, t & 3
        if q == 3:
            continue                  # B rows 12..15: A's zero columns
        for j in range(4):
            one = pk._NARROW[n.src[j] + n.hi_byte]
            assert one.word == 4 * q + j and one.odd == (g >= 4)
            for stream in (0, 1):
                two = pk._NARROW[n.src[j] + stream]
                assert two.word == 4 * q + j and int(two.odd) == stream


@pytest.mark.parametrize("lanes,mxu,threads", [
    (1, 1, pk.WARP), (1024, 1, pk.WARP), (pk.MMA_MAX_LANES, 1, pk.WARP),
    (pk.MMA_MAX_LANES + 1, 1, 1), (28 * 1024, 1, 1), (4 * 28 * 1024, 1, 1),
    (112, 2, pk.WARP), (1024, 2, pk.WARP), (pk.MMA2_MAX_LANES, 2, pk.WARP),
    (pk.MMA2_MAX_LANES + 1, 2, 1), (28 * 1024, 2, 1),
    (1024, 0, pk.SPLIT), (28 * 1024, 0, 1)])
def test_grid_by_lane_count(lanes, mxu, threads):
    """The transcript's and one proof's calls take each kernel's narrow
    grid, a batch's leaf hashes and walks the wide one."""
    assert pk.threads_per_permutation(lanes, mxu) == threads


@pytest.mark.parametrize("mxu", [0, 1, 2])
@pytest.mark.parametrize("lanes", [0, 1, 1024, 28 * 1024])
def test_launch_passes_the_grid_and_counts_launches(monkeypatch, mxu, lanes):
    """The wrapper's launch with a fake library: the grid argument follows
    the lane count, one launch is counted a call, and none for 0 lanes (the
    C entry points launch nothing there)."""
    calls = []

    def fake_kernel(in_ptr, out_ptr, n, threads_per_perm, stream):
        calls.append((n, threads_per_perm))
        return 0

    kernel = pk.KERNELS[mxu]
    monkeypatch.setattr(pk, "_library",
                        lambda name, device: SimpleNamespace(**{kernel: fake_kernel}))
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(pk, "LAUNCHES", {name: 0 for name in pk.KERNELS})
    state = torch.zeros((12, lanes), dtype=torch.int64)
    out = pk._launch(state, mxu)
    assert out.shape == state.shape
    if lanes == 0:
        assert calls == [] and pk.LAUNCHES[kernel] == 0
    else:
        assert calls == [(lanes, pk.threads_per_permutation(lanes, mxu))]
        assert pk.LAUNCHES == {name: int(name == kernel) for name in pk.KERNELS}


class _FakeFunction:
    def __init__(self, log, name):
        self.log, self.name, self.argtypes, self.restype = log, name, None, None

    def __call__(self, *args):
        if self.name.endswith("_constants"):   # copy the table, as the upload does
            words = 12 + 22 if self.name.endswith("_partial_constants") else 30 * 12
            args = ((ctypes.c_uint64 * words).from_address(args[0])[:],)
        self.log.append((self.name, args))
        return 0


class _FakeLibrary:
    def __init__(self):
        self.log, self.fns = [], {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, _FakeFunction(self.log, name))


def test_library_binds_the_grid_argument_and_both_tables(monkeypatch):
    """`_library` on the tensor-core library: both kernels take
    threads_per_perm as a C int, and both tables are uploaded."""
    from stark_verifier_tpu_torch.ops import cuda_build

    fake = _FakeLibrary()
    monkeypatch.setattr(cuda_build, "load", lambda name: fake)
    monkeypatch.setattr(cuda_build, "_bound", set())
    monkeypatch.setattr(cuda_build, "_served", {})
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())
    assert pk._library("poseidon_gl_mma", torch.device("cuda", 0)) is fake
    rc, partial = pk.schedule_tables()
    assert dict((name, args[0]) for name, args in fake.log) == {
        "poseidon_mma_set_round_constants": rc.tolist(),
        "poseidon_mma_set_partial_constants": partial.tolist()}
    for kernel in pk.KERNELS[1:]:
        assert fake.fns[kernel].argtypes == [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]


def test_bounds_hold_with_room_at_the_extremes():
    """The worst cases the kernel's comments state: a byte sum at most
    264 * 255 < 2^17, a pair below 2^25, each half of a row below 2^41."""
    y = (sum(tconst.MDS_MATRIX_CIRC) + tconst.MDS_MATRIX_DIAG[0]) * 255
    assert y == 264 * 255 < 2**17
    e = pk._pair_bytes(y, y)
    assert e == y * 257 < 2**25
    assert e + (e << 16) < 2**41
    assert pk._fold_pairs(e, e, e, e) % P == (e * (1 + 2**16 + 2**32 + 2**48)) % P
    # all-255 bytes in every word: every D entry at its row's sum times 255
    words = [2**64 - 1] * 12
    assert pk._mds_wide(words, 0) == pk._mds_wide(words, 8)
    assert [v % P for v in pk._mds_wide(words, 0)] == [
        (sum(row) * (2**64 - 1)) % P for row in gl64._mds12_matrix().tolist()]


@pytest.mark.parametrize("case", [
    "mma_byte_sum", "pair_operand", "pair_sum", "fold_pairs_operand",
    "fold_pairs_half", "wide_padding", "holders_disagree", "layout", "state"])
def test_bounds_are_enforced(monkeypatch, case):
    """Each bound the model asserts raises when it is passed."""
    with pytest.raises((ArithmeticError, ValueError)):
        if case == "mma_byte_sum":
            # all bytes 255 in A and B: 16 * 255 * 255 >= 2^17
            pk._mma_u8([(2**32 - 1, 2**32 - 1)] * 32, [2**32 - 1] * 32)
        elif case == "pair_operand":
            pk._pair_bytes(1 << 17, 0)
        elif case == "pair_sum":
            pk._pair_bytes(2**17 - 1, 2**17 - 1)
        elif case == "fold_pairs_operand":
            pk._fold_pairs(1 << 25, 0, 0, 0)
        elif case == "fold_pairs_half":
            pk._fold_pairs(2**25 - 1, 2**25 - 1, 0, 0)
        elif case == "wide_padding":
            odd = [row[:] for row in pk._WIDE_A["odd"]]
            odd[8][0] = 1
            monkeypatch.setitem(pk._WIDE_A, "odd", odd)
            pk.schedule_permute_mma_ints([1] * 12, "wide", 8)
        elif case == "holders_disagree":
            monkeypatch.setattr(pk, "_mds_narrow", lambda w: list(range(32)))
            pk.schedule_permute_mma_ints([0] * 12, "narrow")
        elif case == "layout":
            pk.schedule_permute_mma_ints([0] * 12, "split")
        else:
            pk.schedule_permute_mma_ints([1 << 64] + [0] * 11, "narrow")
