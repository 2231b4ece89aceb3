"""Workload, configuration and traffic files load by name; the traffic
generator's pool; BENCHMARK.json names only what the folder holds."""
import json

import numpy as np
import pytest

from benchmark.harness import files
from benchmark.harness import traffic as tg
from benchmark.runners.verify_batches import load_inputs

from .helpers import small_root


def bench_json():
    return json.loads((files.ROOT / "BENCHMARK.json").read_text())


def test_every_cell_loads_by_name():
    bj = bench_json()
    for wl in bj["workloads"]:
        cell = files.load_cell(wl["name"])
        assert cell.config["name"] == wl["config"]
        assert cell.traffic["name"] == wl["traffic"]
        assert cell.chips == wl["chips"]
        assert cell.traffic["runner"] == "verify_batches"


def test_configs_name_their_files_and_reductions():
    for c in bench_json()["configs"]:
        path = files.ROOT / c["file"]
        data = json.loads(path.read_text())
        assert path == files.BENCH / "configs" / f"{c['name']}.json"
        assert c["reduced"] == data["reduced"] and data["source"] == c["source"]
        files.fixture_path({**data, "name": c["name"]})   # the sha256 holds
        load_inputs({**data, "name": c["name"]})           # and the unsound proofs'


def test_a_changed_fixture_fails(tmp_path):
    cfg = json.loads((files.BENCH / "configs" / "zk20.json").read_text())
    (tmp_path / "fixtures").mkdir()
    (tmp_path / cfg["fixture"]).write_bytes(b"not the fixture")
    with pytest.raises(files.FixtureChanged):
        files.fixture_path({**cfg, "name": "zk20"}, root=tmp_path)
    with pytest.raises(files.FixtureChanged):
        files.fixture_path({**cfg, "name": "zk20", "fixture": "fixtures/none.npz"},
                           root=tmp_path)


def test_names_are_checked():
    with pytest.raises(ValueError):
        files.load_cell("../BENCHMARK")


@pytest.mark.parametrize("cell", ["wrapped.b256", "zk20.small"])
def test_pool_same_sizes_for_every_seed(cell, tmp_path):
    c = (files.load_cell(cell) if cell != "zk20.small"
         else files.load_cell(cell, small_root(tmp_path, "zk20")))
    arrays, _, _, unsound = load_inputs(c.config)
    pools = [tg.make_pool(arrays, c.config, c.traffic, s, unsound) for s in (1, 2**31 + 9)]
    B, P = c.traffic["batch"], c.traffic["pool_batches"]
    bad = tg.corrupt_count(c.traffic)
    n, K = c.config["distinct_proofs"], len(c.config["unsound_kinds"])
    # every cell's pool holds a late-query flip for the control to miss
    assert bad >= (32 if cell != "zk20.small" else 3)
    for pool in pools:
        assert len(pool.batches) == P and pool.batch == B
        assert len(pool.variants) == bad
        flips = [v for v in pool.variants if not v[1].startswith(tg.UNSOUND)]
        assert len(pool.ref_arrays["public_inputs"]) == n + K + len(flips)
        sites = [v[1] for v in pool.variants]
        counts = [sites.count(s) for s in c.config["corrupt_sites"]]
        assert max(counts) - min(counts) <= 1
        for j, batch in enumerate(pool.batches):
            for k, v in batch.items():
                assert np.array_equal(v, pool.ref_arrays[k][pool.ref_lane[j]])
        for k, site, _, _ in pool.variants:
            if site.startswith(tg.UNSOUND):
                assert tg.UNSOUND + c.config["unsound_kinds"][k] == site
                for name, v in unsound.items():
                    assert np.array_equal(pool.ref_arrays[name][n + k], v[k])
        for i, (src, site, element, bit) in enumerate(flips):
            row = n + K + i
            diff = pool.ref_arrays[site][row].reshape(-1) ^ arrays[site][src].reshape(-1)
            assert np.flatnonzero(diff).tolist() == [element]
            assert int(diff[element]) == 1 << bit
            for k in arrays:
                if k != site:
                    assert np.array_equal(pool.ref_arrays[k][row], arrays[k][src])
    assert pools[0].variants != pools[1].variants


def test_pool_repeats_from_its_seed():
    c = files.load_cell("wrapped.b256")
    arrays, _, _, unsound = load_inputs(c.config)
    a, b = (tg.make_pool(arrays, c.config, c.traffic, 77, unsound) for _ in range(2))
    assert a.variants == b.variants
    assert all(np.array_equal(x, y) for x, y in zip(a.ref_lane, b.ref_lane))
