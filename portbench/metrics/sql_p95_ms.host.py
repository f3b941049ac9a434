"""The 95th percentile of the latency of every statement sent in the
window, from its send to its ReadyForQuery on the client's clock. A
per-layer reading: in a closed loop at capacity the tail restates the
rate (clients over rate, by Little's law) plus the host's scheduling."""


def read(run):
    return run.percentile_ms(95)
