"""copy_in_ms (layer: entry; moves batch_ms_p90): the median, over every
batch of the traced run's window, of the benchmark's span around the
port's `to_device`, ending in a synchronise: u64 arrays on the host to
int64 tensors on the card."""
from benchmark.harness.window import quantile

UNIT = "ms"


def read(run):
    return quantile(run.copy_in_ms, 0.5) if run.copy_in_ms else None
