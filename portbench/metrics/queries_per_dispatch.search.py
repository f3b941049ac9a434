"""Queries the search batcher coalesced per device dispatch in the window
(utils.metrics SearchBatchQueries over SearchBatchDispatches)."""


def read(run):
    if run.counters.batch_dispatches <= 0:
        return None
    return run.counters.batch_queries / run.counters.batch_dispatches
