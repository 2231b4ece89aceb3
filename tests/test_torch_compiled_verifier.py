"""models/flagship.compiled_verifier on the CPU, against the JAX package's
numpy verifier: the compiled form's accept bits (modes "batched" and
"vmap") equal the golden single-proof verifier's, a corrupted proof
rejected; a call checks its argument's keys, shapes, dtypes and device as
the captured graph needs them; and, pinned here because a CUDA graph's
capture refuses them, a call after the first copies nothing from host
memory and reads nothing back (the port's constant tables are uploaded once
a device, ops/gl64.table). On a card the same callable replays a CUDA
graph: chip_smoke.py's `compiled` phase.

The per-proof form costs 4 to 8 s a proof here, so "vmap" and "phased" run
on two proofs (the second corrupted) and the batched form on the whole
case."""
import numpy as np
import pytest
import torch

from stark_verifier_tpu.core import verifier as JV
from stark_verifier_tpu.core.types import load_proofs as jload_proofs
from stark_verifier_tpu.models import flagship as JFS
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu_torch.core.types import load_proofs
from stark_verifier_tpu_torch.models import flagship as TFS
from stark_verifier_tpu_torch.ops import gl64


# fixture, how many of its proofs, the lane corrupted (an opening flipped)
CASES = [("sem_entry8", 8, 5), ("sem_zk20b64", 4, 2)]
_cache = {}


class Case:
    """A fixture's first n proofs as the batched dict on the CPU, clean and
    with one lane corrupted, and the golden verifier's bits for each."""

    def __init__(self, name, n, lane):
        jproofs, jcommon, jvk = jload_proofs(JFS.FIXTURE_DIR / f"{name}.npz")
        proofs, self.common, self.vk = load_proofs(TFS.FIXTURE_DIR / f"{name}.npz")
        batched = TFS.batched_arrays(proofs[:n])
        bad = {k: v.copy() for k, v in batched.items()}
        bad["open_wires"][lane, 0, 0] ^= np.uint64(1)
        self.want = [bool(JV.verify_proof(gl, jcommon, jvk, p)) for p in jproofs[:n]]
        pa_j = JV.arrays_to_backend(gl, {k: v[lane] for k, v in bad.items()})
        self.want_bad = list(self.want)
        self.want_bad[lane] = bool(JV.verify(
            gl, jcommon, gl.from_u64(jvk.constants_sigmas_cap),
            gl.from_u64(jvk.circuit_digest), pa_j))
        _, to_device = TFS.make_verifier_fn_batched(self.common, self.vk, device="cpu")
        self.pa, self.pa_bad = to_device(batched), to_device(bad)
        # two proofs for the per-proof forms: a clean one, then the corrupted
        self.pair = {k: torch.stack([self.pa[k][0], self.pa_bad[k][lane]])
                     for k in self.pa}
        self.want_pair = [self.want[0], self.want_bad[lane]]
        assert all(self.want) and self.want_pair == [True, False]

    def compile(self, mode, pa=None):
        return TFS.compiled_verifier(self.common, self.vk,
                                     self.pa if pa is None else pa, mode=mode,
                                     device="cpu")


def _case(name, n, lane):
    if name not in _cache:
        _cache[name] = Case(name, n, lane)
    return _cache[name]


@pytest.mark.parametrize("name,n,lane", CASES)
def test_batched_bits_equal_reference(name, n, lane):
    """Two calls through one compiled verifier: each returns its own bits,
    and the second leaves the first's result as it was."""
    c = _case(name, n, lane)
    fn = c.compile("batched")
    assert isinstance(fn, TFS.CompiledVerifier) and fn.graph is None
    first = fn(c.pa)
    kept = first.clone()
    assert first.dtype == torch.bool and tuple(first.shape) == (n,)
    assert first.tolist() == c.want
    second = fn(c.pa_bad)
    assert second.tolist() == c.want_bad and not c.want_bad[lane]
    assert torch.equal(first, kept) and second.data_ptr() != first.data_ptr()


@pytest.mark.parametrize("name,n,lane", CASES)
def test_vmap_bits_equal_reference(name, n, lane):
    c = _case(name, n, lane)
    fn = c.compile("vmap", c.pair)
    assert isinstance(fn, TFS.CompiledVerifier)
    ok = fn(c.pair)
    assert ok.dtype == torch.bool and ok.tolist() == c.want_pair


def test_refuses_other_keys_shapes_dtypes_and_device():
    c = _case(*CASES[0])
    fn = c.compile("batched")
    pa, n = c.pa, CASES[0][1]
    fewer = dict(pa)
    del fewer["pow_witness"]
    more = {**pa, "extra": pa["pow_witness"]}
    narrower = {k: v[: n - 1] for k, v in pa.items()}
    as_int32 = {**pa, "pow_witness": pa["pow_witness"].to(torch.int32)}
    as_numpy = {**pa, "pow_witness": gl64.to_u64(pa["pow_witness"])}
    as_meta = {**pa, "pow_witness": pa["pow_witness"].to("meta")}
    for bad in (fewer, more, narrower, as_int32, as_numpy, as_meta):
        with pytest.raises(ValueError):
            fn(bad)


def test_cache_path_mode_and_phased(tmp_path):
    c = _case(*CASES[0])
    with pytest.raises(NotImplementedError, match="serialised"):
        TFS.compiled_verifier(c.common, c.vk, c.pa, cache_path=tmp_path / "exec.bin",
                              mode="batched", device="cpu")
    assert not any(tmp_path.iterdir())
    with pytest.raises(ValueError, match="mode"):
        c.compile("jit")
    phased = c.compile("phased")
    assert not isinstance(phased, TFS.CompiledVerifier)
    assert phased(c.pair).tolist() == c.want_pair


def _refuse(what):
    def refused(*args, **kwargs):
        raise AssertionError(f"{what} called inside a compiled call")
    return refused


@pytest.mark.parametrize("name,n,lane,mode", [
    (*CASES[0], "batched"), (*CASES[1], "batched"), (*CASES[0], "vmap")])
def test_no_host_copy_or_read_after_warm_up(name, n, lane, mode, monkeypatch):
    """What a capture refuses, refused here after one call: uploads
    (torch.from_numpy, gl64.from_u64) and reads to the host (.item,
    .tolist, .cpu, .numpy)."""
    c = _case(name, n, lane)
    if mode == "batched":
        pa, bad, want = c.pa, c.pa_bad, c.want_bad
    else:  # one proof, corrupted
        pa = bad = {k: v[1:] for k, v in c.pair.items()}
        want = [False]
    fn = c.compile(mode, pa)
    fn(pa)  # the warm-up: the tables uploaded
    monkeypatch.setattr(torch, "from_numpy", _refuse("torch.from_numpy"))
    monkeypatch.setattr(gl64, "from_u64", _refuse("gl64.from_u64"))
    for method in ("item", "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, method, _refuse(f"Tensor.{method}"))
    ok = fn(bad)
    monkeypatch.undo()
    assert ok.tolist() == want
