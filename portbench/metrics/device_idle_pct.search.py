"""The share of the traced slice in which no operation ran on the device
(torch.profiler's kernels, copies and fills), in percent."""


def read(run):
    sl = run.slice
    if sl is None or not sl.device:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
