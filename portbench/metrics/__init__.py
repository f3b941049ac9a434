"""One reader a metric, `<metric>.py`, found by the metric's name in
BENCHMARK.json: `read(run)` takes a `harness.Run` and returns the value,
or None where the run has nothing to read (the harness then leaves the
metric out of the line)."""
