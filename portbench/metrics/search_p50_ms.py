"""The median latency of the same statements as the p95."""


def read(run):
    return run.percentile_ms(50)
