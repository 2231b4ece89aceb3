"""The trace's reduction and the per-layer metrics over a made-up trace."""
import pytest

from benchmark.runners.verify_batches import Run, per_layer
from benchmark.harness import yardstick
from benchmark.harness.trace import Trace, short_name

MS = 1_000_000   # ns


def made_up(batches=2):
    """Each batch 10 ms: copy_in 0-3 (a copy 1-3), replay 3-9 (two Poseidon
    kernels of 1 ms, a gl_mul of 2 ms, a gl_mul_add of 1 ms), readback 9-10."""
    t = Trace()
    for b in range(batches):
        o = b * 10 * MS
        t.spans += [("copy_in", o, o + 3 * MS), ("replay", o + 3 * MS, o + 9 * MS),
                    ("readback", o + 9 * MS, o + 10 * MS)]
        t.ops += [("Memcpy HtoD (Pageable -> Device)", o + 1 * MS, o + 3 * MS),
                  ("void poseidon_permute_kernel<12>(unsigned long const*)", o + 3 * MS, o + 4 * MS),
                  ("void gl_mul_kernel<true>(unsigned long const*)", o + 4 * MS, o + 6 * MS),
                  ("void gl_mul_add_kernel<false>(unsigned long const*)", o + 6 * MS, o + 7 * MS),
                  ("void poseidon_permute_mma_narrow_kernel(unsigned long const*)",
                   o + 7 * MS, o + 8 * MS)]
    t.batches = batches
    return t


def test_busy_idle_and_breakdown():
    t = made_up()
    assert t.window_s == pytest.approx(0.020)
    assert t.busy_s == pytest.approx(0.014)
    assert t.device_s(r"poseidon_permute\w*_kernel") == pytest.approx(0.004)
    idle = dict(t.idle_by_span())
    assert idle == pytest.approx({"copy_in": 0.002, "replay": 0.002, "readback": 0.002})
    top = dict(t.top_ops(10))
    assert top == pytest.approx({"gl_mul_kernel<true>": 0.004,
                                 "Memcpy HtoD (Pageable -> Device)": 0.004,
                                 "poseidon_permute_kernel<12>": 0.002,
                                 "poseidon_permute_mma_narrow_kernel": 0.002,
                                 "gl_mul_add_kernel<false>": 0.002})
    assert short_name("void poseidon_permute_kernel<12>(unsigned long const*)") == \
        "poseidon_permute_kernel<12>"
    assert short_name("void at::native::(anonymous namespace)::cat<long>(long*, int)") == \
        "at::native::(anonymous namespace)::cat<long>"
    assert short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD (Pageable -> Device)"
    assert short_name("bridge_permute12_kernel(unsigned long long const*, long long)") == \
        "bridge_permute12_kernel"


def test_metrics_read_or_stay_silent():
    run = Run(config={"hasher": "poseidon"}, batch=1024, copy_in_ms=[3.0, 1.0, 2.0],
              batch_ms=[9.0, 10.0, 11.0], graph_nodes=16285, trace=made_up(), per_proof={"poseidon": 2628.0})
    got = per_layer(run)
    assert got["copy_in_ms"] == {"value": 2.0, "unit": "ms"}
    assert got["graph_nodes"]["value"] == 16285
    assert got["field_kernel_ms"]["value"] == pytest.approx(3.0)
    assert got["device_idle_pct"]["value"] == pytest.approx(30.0)
    least_ms = 2628 * 1024 * yardstick.GL_PERMUTATION_S * 1e3
    assert got["poseidon_permute_roofline"]["value"] == pytest.approx(100 * least_ms / 2.0)
    assert "bridge_permute12_roofline" not in got
    run.config = {"hasher": "bn254"}
    assert "poseidon_permute_roofline" not in per_layer(run)
    assert "bridge_permute12_roofline" not in per_layer(run)   # no bridge kernel ran


def test_least_times_are_the_dispatch_bound():
    assert yardstick.GL_SIMT + (472 * 4 + 30 * 290) == 472 * 20 + 129 * 9 + 30 * 410
    assert yardstick.BRIDGE_SIMT + yardstick.BRIDGE_PRODUCTS == 233_684
    assert yardstick.GL_PERMUTATION_S == pytest.approx(12_313 / 33.5e12)
    assert yardstick.BRIDGE_PERMUTATION_S == pytest.approx(120_984 / 33.5e12)
