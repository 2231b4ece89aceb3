"""The rest of a run, the chip's look skipped, with the timed path broken
underneath: `correct` comes out true for a sound stand-in of the program
and false for each fault a verifying cell can have, and for the control."""
import numpy as np
import pytest
import torch

from benchmark.runners import verify_batches as runner
from benchmark.harness import files, stand_in
from benchmark.harness import traffic as tg
from benchmark.reference.verify import verify_lanes

from .helpers import small_root

SEED = 2**31 + 11
_CACHE = {}


def reference(common, vk, arrays, device, queries=None, quotient=True):
    """verify_lanes, once a set of lanes."""
    key = (tuple(stand_in.lane_keys(arrays)), queries, quotient)
    if key not in _CACHE:
        torch.set_num_threads(4)
        _CACHE[key] = verify_lanes(common, vk, arrays, device, queries=queries,
                                   quotient=quotient)
    return _CACHE[key]


def pool_of(cell, seed):
    arrays, _, _, unsound = runner.load_inputs(cell.config)
    return tg.make_pool(arrays, cell.config, cell.traffic, seed, unsound)


class Stale(stand_in.TableVerifier):
    """A step that returns its state unchanged: each batch gets the answer
    of the batch before (the first, all accepted)."""

    def verify(self, batch):
        now = super().verify(batch)
        prev = getattr(self, "prev", np.ones_like(now))
        self.prev = now
        return prev


class Half(stand_in.TableVerifier):
    """Half of the batch left out: the second half answered with the
    first half's bits."""

    def verify(self, batch):
        bits = super().verify(batch)
        h = len(bits) // 2
        bits[h:2 * h] = bits[:h]
        return bits


class Flipped(stand_in.TableVerifier):
    """One answer altered where it is produced: the first lane of the
    second call, the window's first batch (the first warms the loop)."""

    def verify(self, batch):
        bits = super().verify(batch)
        self.calls = getattr(self, "calls", 0) + 1
        if self.calls == 2:
            bits[0] = ~bits[0]
        return bits


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return files.load_cell("zk20.small", small_root(tmp_path_factory.mktemp("small"), "zk20"))


def drive(cell, kind, queries=None, seed=SEED, quotient=True):
    _, common, vk, _ = runner.load_inputs(cell.config)
    pool = pool_of(cell, seed)
    bits, _ = reference(common, vk, pool.ref_arrays, "cpu", queries, quotient)

    def program(fixture, first, device):
        return kind(pool.ref_arrays, bits)

    result, checks, _ = runner.run(cell, seed, 0.3, False, 0.0, program=program,
                                   device="cpu", reference=reference)
    assert checks["mismatched_lanes"]["limit"] == 0
    assert result["attempted"] >= cell.traffic["batch"]
    assert list(result["metrics"]) == ["verified_proofs_per_s", "batch_ms_p90", "setup_s"]
    return result, checks


def test_sound_stand_in_is_correct(cell):
    result, checks = drive(cell, stand_in.TableVerifier)
    assert result["correct"] and result["failed"] == 0


@pytest.mark.parametrize("fault", [Stale, Half, Flipped])
def test_each_fault_is_not_correct(cell, fault):
    # each batch's corrupted lanes sit elsewhere, so a stale answer is wrong
    pool = pool_of(cell, SEED)
    marks = [frozenset(np.flatnonzero(lanes >= pool.n_honest)) for lanes in pool.ref_lane]
    assert len(set(marks)) == len(marks)
    result, checks = drive(cell, fault)
    assert not result["correct"]
    assert result["failed"] == checks["mismatched_lanes"]["value"] > 0


def test_the_control_is_not_correct(cell):
    q = cell.config["num_query_rounds"] // 2
    per_query = pool_of(cell, SEED).ref_arrays["init_sibs_1"][0][0].size

    def late(seed):
        """Whether the seed's pool flips a sibling of a query the control skips."""
        return any(site == "init_sibs_1" and element // per_query >= q
                   for _, site, element, _ in pool_of(cell, seed).variants)

    seed = next(s for s in range(SEED, SEED + 100) if late(s))
    result, checks = drive(cell, stand_in.TableVerifier, queries=q, seed=seed)
    assert not result["correct"]


@pytest.mark.parametrize("kind", ["unsound_gate", "unsound_copy"])
def test_a_verifier_without_the_quotient_check_is_not_correct(cell, kind):
    """The reference with the vanishing polynomial and the quotient check
    skipped accepts the unsound lanes, and only those: a program that
    skipped that layer would pass every other lane of the traffic."""
    seed = next(s for s in range(SEED, SEED + 100)
                if any(v[1] == kind for v in pool_of(cell, s).variants))
    pool = pool_of(cell, seed)
    _, common, vk, _ = runner.load_inputs(cell.config)
    full, _ = reference(common, vk, pool.ref_arrays, "cpu")
    skipped, _ = reference(common, vk, pool.ref_arrays, "cpu", quotient=False)
    unsound = pool.n_honest + np.arange(len(cell.config["unsound_kinds"]))
    assert np.flatnonzero(full != skipped).tolist() == unsound.tolist()
    result, checks = drive(cell, stand_in.TableVerifier, seed=seed, quotient=False)
    assert not result["correct"]
    assert checks["mismatched_lanes"]["value"] >= sum(
        v[1].startswith(tg.UNSOUND) for v in pool.variants)


def test_a_broken_reference_gives_no_result(cell):
    def accepts_all(common, vk, arrays, device):
        return np.ones(len(arrays["public_inputs"]), dtype=bool), {}

    def program(fixture, first, device):
        return stand_in.TableVerifier(first, np.ones(len(first["public_inputs"]), bool))

    with pytest.raises(runner.judge.YardstickBroken):
        runner.run(cell, SEED, 0.1, False, 0.0, program=program, device="cpu",
                   reference=accepts_all)
