"""The measured window: one client, one batch in flight, and the
arithmetic of its end-to-end metrics.

A batch's latency runs from the start of its copy-in to its accept bits on
the host. The window starts its first batch at once and starts another
while its clock has not passed `seconds`; the last batch ends after that.
The rate is every lane of every batch over the whole time from the first
batch's start to the last one's end, and the percentile is over every
batch: a stall inside the window counts in both.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    starts: list = field(default_factory=list)   # clock seconds
    ends: list = field(default_factory=list)
    outputs: list = field(default_factory=list)  # what each batch answered
    pool_index: list = field(default_factory=list)

    @property
    def batches(self) -> int:
        return len(self.ends)

    @property
    def latencies_ms(self) -> list:
        return [(e - s) * 1e3 for s, e in zip(self.starts, self.ends)]

    @property
    def seconds(self) -> float:
        return self.ends[-1] - self.starts[0]


def run_window(step, pool_size: int, seconds: float, first: int = 0,
               clock=time.perf_counter) -> Window:
    """Calls `step(j)` (pool batch j, in turn from `first`), which answers
    one batch end to end, until `seconds` have passed since the first
    call; at least one batch."""
    w = Window()
    t_end = None
    j = first
    while t_end is None or clock() < t_end:
        t0 = clock()
        if t_end is None:
            t_end = t0 + seconds
        out = step(j % pool_size)
        t1 = clock()
        w.starts.append(t0)
        w.ends.append(t1)
        w.outputs.append(out)
        w.pool_index.append(j % pool_size)
        j += 1
    return w


def quantile(values, q: float) -> float:
    """The q-quantile by linear interpolation between the closest ranks
    (numpy's default): the value at rank (n - 1) q of the sorted values."""
    v = sorted(values)
    if not v:
        raise ValueError("quantile of no values")
    h = (len(v) - 1) * q
    lo = math.floor(h)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (h - lo) * (v[hi] - v[lo])


def rate(lanes_per_batch: int, w: Window) -> float:
    """Lanes of every batch of the window over its whole time, a second."""
    return lanes_per_batch * w.batches / w.seconds
