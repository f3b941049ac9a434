"""Kernel launches of the window's statements (serenedb_tpu_torch.device
.LAUNCHES, every wrapper) divided by the statements sent in the window."""


def read(run):
    if not run.records:
        return None
    return sum(run.counters.launches.values()) / len(run.records)
