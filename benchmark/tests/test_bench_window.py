"""The window's arithmetic: the rate over every batch and all of the time,
the percentile over every batch, a stall inside the window included."""
import statistics

import numpy as np
import pytest

from benchmark.harness import window


class FakeClock:
    """A clock that each step advances by a given latency."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def drive(latencies, seconds):
    clock = FakeClock()
    it = iter(latencies)

    def step(j):
        clock.t += next(it)
        return j

    return window.run_window(step, 3, seconds, clock=clock)


def test_rate_and_percentile_with_a_stall():
    lat = [0.01] * 50 + [0.5] + [0.01] * 100
    w = drive(lat, seconds=1.0)
    # starts while the clock is below 1.0 s after the first start: 50 batches
    # (0.5 s), the stall (to 1.0 s), and no more
    assert w.batches == 51
    assert w.seconds == pytest.approx(1.0)
    assert window.rate(8, w) == pytest.approx(8 * 51 / 1.0)
    assert window.quantile(w.latencies_ms, 0.9) == pytest.approx(10.0)
    assert max(w.latencies_ms) == pytest.approx(500.0)
    assert w.pool_index[:5] == [0, 1, 2, 0, 1]


def test_stall_moves_the_tail():
    lat = [0.01] * 80 + [0.2] * 20
    w = drive(lat, seconds=4.7)
    assert w.batches == 100
    assert window.quantile(w.latencies_ms, 0.9) == pytest.approx(200.0)
    assert window.quantile(w.latencies_ms, 0.5) == pytest.approx(10.0)
    assert window.rate(1, w) == pytest.approx(100 / (0.8 + 4.0))


def test_the_last_batch_runs_past_the_close():
    w = drive([0.4, 0.4, 0.4, 0.4], seconds=1.0)
    assert w.batches == 3 and w.seconds == pytest.approx(1.2)


@pytest.mark.parametrize("q", [0.1, 0.5, 0.9, 0.95])
def test_quantile_is_numpys_linear(q):
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 100, 101):
        v = rng.random(n).tolist()
        assert window.quantile(v, q) == pytest.approx(float(np.quantile(v, q)))


def test_quantile_matches_statistics_inclusive_deciles():
    v = list(range(1, 102))
    assert window.quantile(v, 0.9) == pytest.approx(
        statistics.quantiles(v, n=10, method="inclusive")[8])
