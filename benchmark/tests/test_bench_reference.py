"""The plain reference on a few fixture lanes of each configuration: an
honest lane accepted, a bit flipped at each corruption site rejected, the
unsound lanes rejected by the quotient check alone, and the control (half
the FRI queries) blind to a flip in a later query."""
import numpy as np
import pytest
import torch

from benchmark.harness import files
from benchmark.harness.traffic import UNSOUND
from benchmark.reference.types import load_fixture
from benchmark.reference.verify import verify_lanes
from benchmark.runners.verify_batches import load_inputs

CELL = {"zk20": "zk20.b1024", "wrapped": "wrapped.b256"}


def lanes_with_flips(arrays, sites, rng):
    """Lane 0 honest, then lane 0 with one seeded bit flipped at each site."""
    rows = {k: np.repeat(v[:1], 1 + len(sites), axis=0) for k, v in arrays.items()}
    for i, site in enumerate(sites):
        flat = rows[site][1 + i:2 + i].reshape(-1)   # a view, a 0-d lane too
        flat[rng.integers(flat.size)] ^= np.uint64(1 << int(rng.integers(64)))
    return rows


@pytest.mark.parametrize("config", ["zk20", "wrapped"])
def test_honest_accepted_and_every_site_rejected(config):
    torch.set_num_threads(4)
    cfg = files.load_cell(CELL[config]).config
    arrays, common, vk = load_fixture(files.fixture_path(cfg))
    sites = [s for s in cfg["corrupt_sites"] if not s.startswith(UNSOUND)]
    rows = lanes_with_flips(arrays, sites, np.random.default_rng(5))
    bits, per_proof = verify_lanes(common, vk, rows, "cpu")
    assert bits.tolist() == [True] + [False] * len(sites)
    assert set(per_proof) == ({"poseidon"} if cfg["hasher"] == "poseidon"
                              else {"poseidon", "bn254"})


@pytest.mark.parametrize("config", ["zk20", "wrapped"])
def test_unsound_lanes_fail_the_quotient_check_alone(config):
    """Each unsound proof is rejected, and accepted once the vanishing
    polynomial and the quotient check are skipped: its Merkle walks, FRI and
    proof-of-work hold, so no other layer can stand in for that one."""
    torch.set_num_threads(4)
    cfg = files.load_cell(CELL[config]).config
    _, common, vk, unsound = load_inputs(cfg)
    kinds = cfg["unsound_kinds"]
    assert {UNSOUND + k for k in kinds} <= set(cfg["corrupt_sites"])
    assert {"gate", "copy"} <= set(kinds)
    full, _ = verify_lanes(common, vk, unsound, "cpu")
    skipped, _ = verify_lanes(common, vk, unsound, "cpu", quotient=False)
    assert full.tolist() == [False] * len(kinds)
    assert skipped.tolist() == [True] * len(kinds)


def test_the_control_misses_a_flip_in_a_later_query():
    torch.set_num_threads(4)
    cfg = files.load_cell("zk20.b1024").config
    arrays, common, vk = load_fixture(files.fixture_path(cfg))
    rows = {k: np.repeat(v[:1], 3, axis=0) for k, v in arrays.items()}
    rows["init_sibs_1"][1, 27, 3, 0] ^= np.uint64(1)      # the last query
    rows["init_sibs_1"][2, 0, 3, 0] ^= np.uint64(1)       # the first
    full, _ = verify_lanes(common, vk, rows, "cpu")
    half, per_proof = verify_lanes(common, vk, rows, "cpu", queries=14)
    assert full.tolist() == [True, False, False]
    assert half.tolist() == [True, True, False]
    assert per_proof["poseidon"] < 2628
