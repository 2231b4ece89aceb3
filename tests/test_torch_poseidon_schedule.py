"""The Goldilocks Poseidon kernel's schedule on the CPU
(ops/poseidon_kernel: schedule_tables, schedule_permute_ints,
threads_per_permutation). csrc/poseidon_gl.cu runs the partial rounds with
plonky2's forwarded constants and, for narrow calls, spreads a permutation
over SPLIT = 12 threads that each form one MDS row from rotated
coefficients, in two chains of multiply-adds.
The host model runs that schedule on python ints, for both grids, with the
kernel's tables and order of operations, and asserts the value bounds the
kernel relies on; here it is held against `permute_plain`, the JAX
package's numpy golden model and plonky2's published vectors, on
full-range states with every edge value in every position. Exact
equality."""
import re
from pathlib import Path

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
SOURCE = Path(pk.__file__).resolve().parent / "csrc" / "poseidon_gl.cu"


def _states():
    """uint64[12, n]: seeded full-range words, then every edge value in every
    position (one lane an edge value and a position), then each edge value
    in all twelve positions at once."""
    rng = np.random.default_rng(55)
    rand = rng.integers(0, 2**64, size=(12, 6), dtype=np.uint64)
    edge_lanes = []
    for pos in range(12):
        for k, e in enumerate(EDGES):
            lane = rng.integers(0, 2**64, size=12, dtype=np.uint64)
            lane[pos] = e
            lane[(pos + 1 + k) % 12] = EDGES[(k + 3) % len(EDGES)]
            edge_lanes.append(lane)
    uniform = [np.full(12, e, dtype=np.uint64) for e in EDGES]
    return np.concatenate([rand, np.stack(edge_lanes + uniform, axis=1)], axis=1)


STATES = _states()


def _plain(states):
    return gl64.to_u64(pk.permute_plain(gl64.from_u64(states, "cpu")))


def _golden(states):
    return gl64_np.permute12(states % np.uint64(P))


@pytest.fixture(scope="module")
def reference():
    plain = _plain(STATES)
    assert (plain == _golden(STATES)).all()
    return plain


@pytest.mark.parametrize("threads_per_perm", [1, pk.SPLIT])
@pytest.mark.parametrize("part", range(8))
def test_schedule_equals_plain_and_golden(reference, threads_per_perm, part):
    """Every state, in eight parts, through each grid's schedule."""
    n = STATES.shape[1]
    for lane in range(part, n, 8):
        got = pk.schedule_permute_ints(STATES[:, lane].tolist(), threads_per_perm)
        assert got == [int(v) for v in reference[:, lane]], lane


@pytest.mark.parametrize("ins,expected", PLONKY2_TEST_VECTORS_12)
@pytest.mark.parametrize("threads_per_perm", [1, pk.SPLIT])
def test_schedule_plonky2_published_vectors(threads_per_perm, ins, expected):
    assert pk.schedule_permute_ints(ins, threads_per_perm) == expected


def test_tables_are_the_ports_constants():
    rc, partial = pk.schedule_tables()
    assert rc.dtype == np.uint64 and rc.shape == (30 * 12,)
    assert rc.tolist() == list(tconst.ALL_ROUND_CONSTANTS)
    assert partial.dtype == np.uint64 and partial.shape == (12 + 22,)
    assert partial[:12].tolist() == list(tconst.FAST_PARTIAL_FIRST_ROUND_CONSTANT)
    assert partial[12:].tolist() == list(tconst.FAST_PARTIAL_ROUND_CONSTANTS)
    assert partial[-1] == 0    # the last partial round adds nothing
    # what the wrapper uploads for the round constants is the same table as
    # the plain version's
    assert (rc.reshape(30, 12) == gl64._round_constants()).all()


def test_kernel_source_declares_the_tables_the_model_uses():
    # the narrow grid's matrix and constants live in the header it shares
    # with the witness fill
    src = SOURCE.read_text() + (SOURCE.parent / "poseidon_split.cuh").read_text()
    # one table, the round constants and then the forwarded ones, as the
    # two uploads write it
    assert re.search(r"#define PARTIAL_AT \(N_ROUNDS \* WIDTH\)", src)
    assert re.search(r"#define TABLE_WORDS \(PARTIAL_AT \+ WIDTH \+ N_PARTIAL\)", src)
    assert re.search(r"^__device__ u64 TABLES\[TABLE_WORDS\];", src, re.M)
    assert "__constant__ u64" not in src
    m = re.search(r"#define MDS_CIRC \{([^}]*)\}", src)
    assert m and tuple(int(v) for v in m.group(1).split(",")) == pk._CIRC
    assert re.search(r"__constant__ u32 CIRC_TABLE\[WIDTH\] = MDS_CIRC;", src)
    assert re.search(r"constexpr u32 DIAG0 = 8;", src)
    assert pk._CIRC == tconst.MDS_MATRIX_CIRC
    assert (pk._DIAG0,) + (0,) * 11 == tconst.MDS_MATRIX_DIAG
    m = re.search(r"^#define SPLIT (\d+)", src, re.M)
    assert m and int(m.group(1)) == pk.SPLIT


@pytest.mark.parametrize("row", range(12))
def test_row_coefficients_are_the_mds_matrix(row):
    """The rotated coefficients and the diagonal entry give the dense
    matrix's row, in either grid's chains: word j alone, at 1 and at
    2^32 + 1, comes out as the matrix entry times it."""
    mds = gl64._mds12_matrix().tolist()
    diag = pk._DIAG0 if row == 0 else 0
    assert [c + (diag if j == 0 else 0) for j, c in enumerate(pk._row_coeffs(row))] \
        == mds[row]
    for chains in (1, 2):
        for j in range(12):
            for v in (1, 2**32 + 1):
                words = [0] * 12
                words[j] = v
                assert pk._mds_row(pk._row_coeffs(row), words, chains, diag) \
                    == mds[row][j] * v


@pytest.mark.parametrize("lanes,threads", [
    (1, pk.SPLIT), (28, pk.SPLIT), (112, pk.SPLIT), (256, pk.SPLIT), (1024, pk.SPLIT),
    (pk.SPLIT_MAX_LANES, pk.SPLIT),
    (pk.SPLIT_MAX_LANES + 1, 1), (28 * 1024, 1), (4 * 28 * 1024, 1)])
def test_grid_by_lane_count(lanes, threads):
    """The transcript's and one proof's calls take the twelve-thread grid, a
    batch's leaf hashes and walks the one-thread grid."""
    assert pk.threads_per_permutation(lanes) == threads


@pytest.mark.parametrize("case", [
    "add_const_operand", "add_const_constant", "reduce128_operand",
    "fold_row_partial_sum", "mds_row_sum", "mds_row_two_chains", "threads_per_perm",
    "state"])
def test_bounds_are_enforced(case):
    """Each bound the model asserts raises when it is passed."""
    with pytest.raises((ArithmeticError, ValueError)):
        if case == "add_const_operand":
            pk._add_const(1 << 64, 0)
        elif case == "add_const_constant":
            pk._add_const(0, P)
        elif case == "reduce128_operand":
            pk._reduce128(0, 1 << 64)
        elif case == "fold_row_partial_sum":
            pk._fold_row(1 << 41, 0)
        elif case == "mds_row_sum":
            pk._mds_row([1 << 10] * 12, [2**64 - 1] * 12)
        elif case == "mds_row_two_chains":
            pk._mds_row([1 << 10] * 12, [2**64 - 1] * 12, 2, pk._DIAG0)
        elif case == "threads_per_perm":
            pk.schedule_permute_ints([0] * 12, 4)
        else:
            pk.schedule_permute_ints([1 << 64] + [0] * 11)


def test_bounds_hold_with_room_at_the_extremes():
    """The worst cases the kernel's comments state: a row's half-sum at most
    264 * (2^32 - 1) < 2^41, so the row's high word stays below 2^10;
    add_const of the largest word and the largest constant wraps once;
    reduce128 of the largest 128-bit value; every table entry canonical."""
    assert sum(tconst.MDS_MATRIX_CIRC) + tconst.MDS_MATRIX_DIAG[0] == 264
    assert 264 * (2**32 - 1) < 2**41
    assert (264 * (2**32 - 1) * (2**32 + 1)) >> 64 < 2**10
    top = 2**64 - 1
    assert pk._add_const(top, P - 1) % P == (top + P - 1) % P
    assert pk._fold_row(264 * (2**32 - 1), 264 * (2**32 - 1)) % P \
        == (264 * (2**32 - 1) * (2**32 + 1)) % P
    rc, partial = pk.schedule_tables()
    assert all(int(c) < P for c in rc) and all(int(c) < P for c in partial)
    assert pk._reduce128(top, top) % P == (top * 2**64 + top) % P
    assert pk._mds_row([264] + [0] * 11, [top] + [0] * 11) % P == (264 * top) % P
    # row 0 at the largest words, in one chain and in the narrow grid's two
    for chains in (1, 2):
        assert pk._mds_row(pk._row_coeffs(0), [top] * 12, chains, pk._DIAG0) % P \
            == (264 * top) % P


class _FakeFunction:
    def __init__(self, log, name):
        self.log, self.name, self.argtypes, self.restype = log, name, None, None

    def __call__(self, *args):
        import ctypes

        words = 12 + 22 if self.name.endswith("_partial_constants") else 30 * 12
        if self.name.endswith("_constants"):   # copy the table, as the upload does
            args = ((ctypes.c_uint64 * words).from_address(args[0])[:],)
        self.log.append((self.name, self.argtypes, args))
        return 0


class _FakeLibrary:
    """Stands for a loaded CUDA library: records every call with its bound
    argument types."""
    def __init__(self):
        self.log, self.fns = [], {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, _FakeFunction(self.log, name))


@pytest.mark.parametrize("library", ["poseidon_gl", "poseidon_gl_mma"])
def test_wrapper_binds_each_library_and_uploads_its_tables(monkeypatch, library):
    """What `_library` does once a library is built: every kernel takes the
    grid argument, and each library both tables."""
    import contextlib
    import ctypes
    from stark_verifier_tpu_torch.ops import cuda_build

    fake = _FakeLibrary()
    monkeypatch.setattr(cuda_build, "load", lambda name: fake)
    monkeypatch.setattr(cuda_build, "_bound", set())
    monkeypatch.setattr(cuda_build, "_served", {})
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    assert pk._library(library, torch.device("cuda", 0)) is fake
    rc, partial = pk.schedule_tables()
    uploaded = {name: args[0] for name, _, args in fake.log}
    prefix = "poseidon" if library == "poseidon_gl" else "poseidon_mma"
    assert set(uploaded) == {f"{prefix}_set_round_constants",
                             f"{prefix}_set_partial_constants"}
    assert uploaded[f"{prefix}_set_partial_constants"] == partial.tolist()
    for kernel in (pk.KERNELS[:1] if library == "poseidon_gl" else pk.KERNELS[1:]):
        assert fake.fns[kernel].argtypes == [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
    assert all(table == rc.tolist() for name, table in uploaded.items()
               if name.endswith("_round_constants"))
    assert all(types == [ctypes.c_void_p] for name, types, _ in fake.log)
