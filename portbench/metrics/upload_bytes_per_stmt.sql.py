"""Host-to-device bytes that the window's statements uploaded
(serenedb_tpu_torch.device.UPLOADS) divided by the statements sent in
the window; a warm column cache uploads nothing."""


def read(run):
    if not run.records:
        return None
    return run.counters.uploads.get("bytes", 0) / len(run.records)
