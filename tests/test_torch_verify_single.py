"""The per-proof verifier of the port on the CPU: the entry points
`models.flagship.make_verifier_fn` / `make_verifier_fn_phased` against the
JAX package's golden single-proof verifier on its numpy backend (accept
bit) and against the port's own batched path. One proof has no batch axis:
its Poseidon calls have 1, Q and 4 * Q lanes. The challenges, `verify` and
`verify_proof` are in test_torch_verify_single_phases.py, the reject cases
in test_torch_verify_single_reject.py (apart, so that each file stays
short). Exact equality throughout; nothing here compiles the JAX verifier."""
from pathlib import Path

import pytest
import torch

from stark_verifier_tpu.core import verifier as JV
from stark_verifier_tpu.core.types import load_proofs as jload_proofs
from stark_verifier_tpu.ops import gl64_np as gl
from stark_verifier_tpu_torch.core import types as ttypes
from stark_verifier_tpu_torch.models import flagship as TFS
from stark_verifier_tpu_torch.ops import gl64 as gt
from stark_verifier_tpu_torch.ops import poseidon_gl as tpg

REPO = Path(__file__).resolve().parent.parent
F = gt.Field("cpu")

# fixture, how many of its proofs: no fold layer and cap height 1; the same
# with salted leaves; four arity-2 fold layers and cap height 4 (the zk20
# circuit of the main path)
CASES = [("sem_entry8", 2), ("sem_zk_small8", 2), ("sem_zk20b64", 2)]
_loaded = {}


def _load(name, n):
    """(the port's proofs, common, vk, device dict; the reference's proofs,
    common, vk) for the first n proofs of a fixture."""
    if (name, n) not in _loaded:
        path = REPO / "fixtures" / f"{name}.npz"
        proofs, common, vk = ttypes.load_proofs(path)
        jproofs, jcommon, jvk = jload_proofs(path)
        pa = {k: F.from_u64(v)
              for k, v in TFS.batched_arrays(proofs[:n]).items()}
        _loaded[(name, n)] = (proofs[:n], common, vk, pa,
                              jproofs[:n], jcommon, jvk)
    return _loaded[(name, n)]


@pytest.mark.parametrize("name,n", CASES)
def test_accept_bits_match_reference_and_batched_path(name, n):
    proofs, common, vk, pa, jproofs, jcommon, jvk = _load(name, n)
    want = [bool(JV.verify_proof(gl, jcommon, jvk, jp)) for jp in jproofs]
    assert all(want)
    lanes = []

    def recording(F_, state):
        lanes.append(state.numel() // 12)
        return tpg.permute(F_, state)

    fn, to_device = TFS.make_verifier_fn(common, vk, device="cpu",
                                         permute=recording)
    ok = fn(pa)
    assert ok.dtype == torch.bool and ok.shape == (n,) and ok.tolist() == want
    q = common.config.fri_config.num_query_rounds
    assert set(lanes) == {1, q, 4 * q}  # one proof: no batch in the lanes
    phased, _ = TFS.make_verifier_fn_phased(common, vk, device="cpu")
    assert phased(pa).tolist() == want
    batched, _ = TFS.make_verifier_fn_batched(common, vk, device="cpu")
    assert batched(pa).tolist() == want
    # to_device carries the u64 dict across as the batched entry's does
    again = to_device(TFS.batched_arrays(proofs))
    assert all(torch.equal(again[k], pa[k]) for k in pa)


@pytest.mark.parametrize("maker", ["make_verifier_fn", "make_verifier_fn_phased"])
def test_entry_points_default_to_the_gpu_and_raise_without_one(maker):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is served")
    proofs, common, vk, *_ = _load("sem_entry8", 2)
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(TFS, maker)(common, vk)
