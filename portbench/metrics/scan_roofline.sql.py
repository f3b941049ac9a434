"""The statements' share of the memory roofline in the traced slice: the
least bytes that the slice's work must move, at the card's peak rate,
over the device time of the slice's kernels, in percent. A statement's
least bytes are counted by the configuration's reference from the
statement and the generated table; the slice's work is every statement
whose time overlaps the slice, in the share of its time that lies inside
(`Run.slice_shares`), so a statement that straddles an end of the slice
counts in the bytes as its kernels count in the time."""

from portbench.peaks import HBM_BYTES_PER_S


def read(run):
    sl = run.slice
    work = run.slice_shares()
    if sl is None or not work or sl.kernel_s() <= 0:
        return None
    total = run.reference.least_bytes_all([w[0] for w in work],
                                          [w[1] for w in work])
    return 100.0 * total / HBM_BYTES_PER_S / sl.kernel_s()
