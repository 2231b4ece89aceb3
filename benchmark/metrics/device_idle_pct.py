"""device_idle_pct (layer: device; moves verified_proofs_per_s): the share
of a batch's time in which no operation ran on the card: 1 - the device's
busy time a batch in the traced stretch (the union of its kernels, copies
and sets) over the median batch time of the traced run's window. The
window runs without the profiler: under it each graph node costs about
1.7 us more, which the profiled stretch's own idle share (busy_s over
window_s) counts as idle."""
from benchmark.harness.window import quantile

UNIT = "%"


def read(run):
    if run.trace is None or not run.batch_ms:
        return None
    busy_ms = run.trace.busy_s / run.trace.batches * 1e3
    return 100.0 * (1.0 - busy_ms / quantile(run.batch_ms, 0.5))
