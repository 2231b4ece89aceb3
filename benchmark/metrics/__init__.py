"""Per-layer metrics, one module a metric, named as the metric: each has
`UNIT` and `read(run)`, which returns the value, or None where the run has
nothing for it to read (the harness then leaves the metric out)."""
