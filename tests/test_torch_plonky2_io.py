"""The port's proof codec (core/plonky2_io.py), its fixture writer
(core/types.save_proofs), constant_arity_bits and tools/torch_cross_check.py
against the JAX package's on the CPU: plonky2's bytes and serde JSON equal
the reference's for three fixtures (no fold layer; four fold layers and
salted leaves; the bn254-wrapped circuit, cap height 0), each side decodes
the other's output, a decoded proof verifies with the port, and bytes
decoded with another circuit's CommonData raise. Exact equality."""
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stark_verifier_tpu.core import plonky2_io as rio
from stark_verifier_tpu.core import types as rtypes
from stark_verifier_tpu.core import verifier as RV
from stark_verifier_tpu_torch.core import plonky2_io as tio
from stark_verifier_tpu_torch.core import types as ttypes
from stark_verifier_tpu_torch.core import verifier as TV
from stark_verifier_tpu_torch.ops import gl64 as gt

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "fixtures"
NAMES = ["sem_entry8", "sem_zk20b64", "sem_wrapped16"]
_loaded = {}


def _load(name):
    if name not in _loaded:
        _loaded[name] = (ttypes.load_proofs(FIX / f"{name}.npz"),
                         rtypes.load_proofs(FIX / f"{name}.npz"))
    return _loaded[name]


def _arrays_equal(a, b):
    """Every array of the two proofs equal. Two empty arrays count as equal
    whatever their shapes: serde JSON does not carry the cap size of the
    FRI commit-phase caps, so a proof with no fold layer decodes them as
    [0, 1, 4] on both sides, whatever the cap height."""
    x, y = TV.proof_to_arrays(a), RV.proof_to_arrays(b)
    return x.keys() == y.keys() and all(
        np.array_equal(x[k], y[k]) or x[k].size == y[k].size == 0 for k in x)


ENCODE = {"bytes": (tio.proof_to_bytes, rio.proof_to_bytes),
          "json": (tio.proof_to_json, rio.proof_to_json)}


@pytest.mark.parametrize("fmt", ENCODE)
@pytest.mark.parametrize("name", NAMES)
def test_encoding_equals_reference(name, fmt):
    (tp, _, _), (rp, _, _) = _load(name)
    port, ref = ENCODE[fmt]
    assert port(tp[0]) == ref(rp[0])


@pytest.mark.parametrize("fmt", ENCODE)
@pytest.mark.parametrize("name", NAMES)
def test_each_side_decodes_the_others_output(name, fmt):
    (tp, tc, _), (rp, rc, _) = _load(name)
    if fmt == "bytes":
        from_port = rio.proof_from_bytes(tio.proof_to_bytes(tp[0]), rc)
        from_ref = tio.proof_from_bytes(rio.proof_to_bytes(rp[0]), tc)
    else:
        from_port = rio.proof_from_json(tio.proof_to_json(tp[0]))
        from_ref = tio.proof_from_json(rio.proof_to_json(rp[0]))
    assert _arrays_equal(tp[0], from_port)
    assert _arrays_equal(from_ref, rp[0])


def test_decoded_proof_verifies_with_the_port():
    """Proof 0 of sem_entry8 through bytes (JSON decodes to the same arrays,
    above), and the same with a flipped opening, through the port's
    per-proof verifier on the CPU."""
    (tp, tc, tvk), _ = _load("sem_entry8")
    data = tio.proof_to_bytes(tp[0])
    flipped = tio.proof_from_bytes(data, tc)
    flipped.openings.wires[0, 0] ^= np.uint64(1)
    F = gt.Field("cpu")
    oks = [bool(TV.verify_proof(F, tc, tvk, p))
           for p in (tio.proof_from_bytes(data, tc), flipped)]
    assert oks == [True, False]


PAIRS = [(a, b) for a in NAMES for b in NAMES if a != b]


@pytest.mark.parametrize("name,other", PAIRS)
def test_bytes_with_another_circuits_common_data_raise(name, other):
    (tp, _, _), _ = _load(name)
    (_, oc, _), (_, orc, _) = _load(other)
    data = tio.proof_to_bytes(tp[0])
    with pytest.raises(ValueError, match="common data does not match"):
        tio.proof_from_bytes(data, oc)
    with pytest.raises(ValueError):
        rio.proof_from_bytes(data, orc)


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_save_proofs_round_trips(tmp_path, direction):
    (tp, tc, tvk), (rp, rc, rvk) = _load("sem_zk20b64")
    path = tmp_path / "proofs.npz"
    if direction == "port_to_reference":
        ttypes.save_proofs(path, tp[:3], tc, tvk)
        back, common, vk = rtypes.load_proofs(path)
        assert all(_arrays_equal(a, b) for a, b in zip(tp[:3], back))
    else:
        rtypes.save_proofs(path, rp[:3], rc, rvk)
        back, common, vk = ttypes.load_proofs(path)
        assert all(_arrays_equal(b, a) for a, b in zip(rp[:3], back))
    assert len(back) == 3 and common.to_json() == rc.to_json()
    assert np.array_equal(vk.constants_sigmas_cap, rvk.constants_sigmas_cap)
    assert np.array_equal(vk.circuit_digest, rvk.circuit_digest)


@pytest.mark.parametrize("arity_bits", [1, 2, 3, 4])
def test_constant_arity_bits_equals_reference(arity_bits):
    for final_poly_bits in range(0, 8):
        for degree_bits in range(max(final_poly_bits, 1), 22):
            for rate_bits in (1, 2, 3, 4):
                for cap_height in (0, 1, 4, 8):
                    args = (arity_bits, final_poly_bits, degree_bits, rate_bits, cap_height)
                    assert _outcome(ttypes.constant_arity_bits, args) == _outcome(
                        rtypes.constant_arity_bits, args), args


def _outcome(fn, args):
    """The result, or the exception's type where the folding cannot go on
    (an arity wider than the degree left)."""
    try:
        return fn(*args)
    except AssertionError as e:
        return type(e)


def _tool(path):
    spec = importlib.util.spec_from_file_location(path.stem + "_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_emit_sample_writes_the_reference_tools_files(tmp_path, capsys):
    _tool(REPO / "tools" / "torch_cross_check.py").emit_sample(tmp_path / "port")
    _tool(REPO / "tools" / "cross_check.py").emit_sample(tmp_path / "ref")
    for f in ("proof.bin", "proof.json", "common.json", "vk.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f


def test_cross_check_tool_accepts_the_entry_fixture_on_the_cpu():
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "torch_cross_check.py"), "--device", "cpu",
         str(FIX / "sem_entry8.npz")], capture_output=True, text=True, timeout=240,
        cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "CROSS_CHECK: 8/8 ACCEPT" in out.stdout


def test_cross_check_tool_refuses_cuda_without_a_card(tmp_path):
    _tool(REPO / "tools" / "torch_cross_check.py").emit_sample(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tool(REPO / "tools" / "torch_cross_check.py").main(
            [str(tmp_path / "proof.bin"), "--common", str(tmp_path / "common.json"),
             "--vk", str(tmp_path / "vk.json")])
