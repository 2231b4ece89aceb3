"""The JAX package's side of the port's recursion tests
(tests/test_torch_recursion*.py), frozen to one file.

Those six files hold the port's aggregation levels, trees and wrapper
against the JAX package's at the tiny inner circuit of tests/test_recursion.py.
The JAX package never changes, and everything it draws here is seeded, so its
outputs are fixed: its circuits (as records: rows, copy constraints, public
inputs, common data, key), its proofs and its generators' end states are
built once, by `python tests/recursion_reference.py` (about two minutes on
the CPU), into fixtures/recursion_reference.pkl.xz, whose sha256 is pinned
below. The tests read them from there instead of building them in every
file; the port's side is always built by the tests themselves. The JAX
package's own recursion tests (tests/test_recursion.py) build the same
objects live.

The file is a pickle written by this module; `load` checks its sha256
before it unpickles it."""
import hashlib
import lzma
import pickle
import sys
from functools import cache
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
FILE = REPO / "fixtures" / "recursion_reference.pkl.xz"
SHA256 = "323d0f12f5fa26b6d422f4f516cdd20ff29e34921a5f9ffe60b85094b84c6d36"

HASHERS = ("poseidon", "bn254")
ZK_SEEDS = (501, 502)   # the zero-knowledge levels' witness and salt generators


def circuit_record(data) -> dict:
    """What tests/test_torch_recursion.assert_circuits_equal compares of a
    circuit: rows, gate constants, copy constraints, public inputs, common
    data and verifying key."""
    b = data.builder
    return {"gate_rows": [(g.id, [int(c) for c in cs]) for g, cs in b.gate_rows],
            "copy_constraints": list(b.copy_constraints),
            "public_inputs": list(b.public_inputs),
            "common": data.common.to_json(),
            "circuit_digest": np.asarray(data.vk.circuit_digest),
            "constants_sigmas_cap": np.asarray(data.vk.constants_sigmas_cap)}


def common_of(record):
    """The JAX package's CommonData of a circuit record."""
    from stark_verifier_tpu.core.types import CommonData

    return CommonData.from_json(record["common"])


def vk_of(record):
    """The JAX package's verifying key of a circuit record."""
    from stark_verifier_tpu.core.types import VerifierOnlyData

    return VerifierOnlyData(record["constants_sigmas_cap"], record["circuit_digest"])


def ref_with_generators(gens, fn, *args, **kw):
    """fn(*args, **kw) in the JAX package, its fresh default_rng() calls
    answered by `gens` in turn (witness, salt, witness, salt, ...)."""
    turns = iter(gens * 8)
    real = np.random.default_rng
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(np.random, "default_rng",
                   lambda s=None: next(turns) if s is None else real(s))
        return fn(*args, **kw)
    finally:
        mp.undo()


def build() -> dict:
    """Every JAX package output the six files compare against, live."""
    from stark_verifier_tpu.prover.recursion import recursion_config
    from stark_verifier_tpu.semaphore import recursion as RR
    from test_recursion import build_tiny_inner

    out = {}
    inner = {}
    for batch in (4, 2):
        proofs, data, root = build_tiny_inner(batch=batch)
        inner[batch] = (proofs, data)
        out[f"inner{batch}"] = {"proofs": proofs, "circuit": circuit_record(data),
                                "root": root}
    proofs, data = inner[4]
    # one aggregation level over the four inner proofs (two pairs), and the
    # tree of four (two levels)
    agg = RR.build_aggregation_circuit(data.common)
    out["level"] = {"circuit": circuit_record(agg.data),
                    "proofs": RR.prove_aggregation_level(agg, proofs, data.vk)}
    final, final_data, levels = RR.aggregate_proofs(proofs, data.common, data.vk)
    out["tree"] = {"circuit": circuit_record(final_data), "proof": final,
                   "levels": len(levels)}
    # the wrapper under both hash configs, and the wrapped proof under bn254
    proofs2, data2 = inner[2]
    wrappers = {h: RR.build_wrapper_circuit(data2.common, hasher=h) for h in HASHERS}
    out["wrapper"] = {"circuits": {h: circuit_record(w.data) for h, w in wrappers.items()},
                      "proofs": wrappers["bn254"].prove(proofs2[:1], data2.vk)}
    # zero knowledge on: the first level, then the second from where the
    # first leaves the generators
    cfg = recursion_config(data.common.config.fri_config, zero_knowledge=True)
    gens = [np.random.default_rng(s) for s in ZK_SEEDS]
    zagg = RR.build_aggregation_circuit(data.common, cfg)
    children = ref_with_generators(gens, RR.prove_aggregation_level, zagg, proofs, data.vk)
    out["zk_level"] = {"circuit": circuit_record(zagg.data), "proofs": children,
                       "gen_states": [g.bit_generator.state for g in gens]}
    final, final_data, levels = ref_with_generators(
        gens, RR.aggregate_proofs, children, zagg.data.common, zagg.data.vk, cfg)
    out["zk_tree"] = {"circuit": circuit_record(final_data), "proof": final,
                      "levels": len(levels),
                      "gen_states": [g.bit_generator.state for g in gens]}
    return out


@cache
def load() -> dict:
    blob = FILE.read_bytes()
    got = hashlib.sha256(blob).hexdigest()
    if got != SHA256:
        raise RuntimeError(f"{FILE.name}: sha256 {got}, pinned {SHA256}; regenerate it with "
                           f"`python tests/recursion_reference.py` and pin the new sum")
    return pickle.loads(lzma.decompress(blob))


def main() -> None:
    sys.path.insert(0, str(REPO / "tests"))
    import conftest  # noqa: F401  (JAX on the CPU)

    blob = lzma.compress(pickle.dumps(build(), protocol=5), preset=9)
    FILE.write_bytes(blob)
    print(f"{FILE}: {len(blob)} bytes, sha256 {hashlib.sha256(blob).hexdigest()}")


if __name__ == "__main__":
    main()
