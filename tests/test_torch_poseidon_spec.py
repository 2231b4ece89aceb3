"""The port's derivation of plonky2's fast partial-round Poseidon tables
(ops/poseidon_spec.py): equal to the tables the port carries as data, to
the JAX package's derivation, and to what poseidon_kernel.schedule_tables()
uploads to the Poseidon kernels. Exact python ints."""
import pytest

from stark_verifier_tpu.ops import poseidon_spec as rspec
from stark_verifier_tpu_torch.ops import _poseidon_gl_constants as tc
from stark_verifier_tpu_torch.ops import poseidon_kernel as pk
from stark_verifier_tpu_torch.ops import poseidon_spec as tspec

TABLES = ["FAST_PARTIAL_FIRST_ROUND_CONSTANT", "FAST_PARTIAL_ROUND_CONSTANTS",
          "FAST_PARTIAL_ROUND_INITIAL_MATRIX", "FAST_PARTIAL_ROUND_W_HATS",
          "FAST_PARTIAL_ROUND_VS"]
_derived = {}


def _port():
    if "port" not in _derived:
        _derived["port"] = tspec.derive_fast_partial_tables()
    return _derived["port"]


@pytest.mark.parametrize("table", TABLES)
def test_derived_equals_the_ports_constants(table):
    assert _port()[table] == [int(x) for x in getattr(tc, table)]


@pytest.mark.parametrize("table", TABLES)
def test_derived_equals_the_reference_derivation(table):
    if "ref" not in _derived:
        _derived["ref"] = rspec.derive_fast_partial_tables()
    assert _port()[table] == _derived["ref"][table]


def test_derived_equals_what_the_kernels_upload():
    rc, partial = pk.schedule_tables()
    t = _port()
    assert [int(x) for x in partial] == (t["FAST_PARTIAL_FIRST_ROUND_CONSTANT"]
                                         + t["FAST_PARTIAL_ROUND_CONSTANTS"])
    assert [int(x) for x in rc] == [int(x) for x in tc.ALL_ROUND_CONSTANTS]


def test_table_sizes_and_the_last_partial_constant():
    t = _port()
    assert [len(t[k]) for k in TABLES] == [12, 22, 11 * 11, 22 * 11, 22 * 11]
    assert t["FAST_PARTIAL_ROUND_CONSTANTS"][-1] == 0


def test_mds_inverse_and_matrix_equal_the_reference():
    m = tspec.mds_row_vector_matrix()
    assert m == rspec.mds_row_vector_matrix()
    ident = tspec.mat_mul(m, tspec.mat_inv(m))
    assert ident == [[int(i == j) for j in range(12)] for i in range(12)]
