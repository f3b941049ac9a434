"""Set-up: from the process's start to the window's start (generate the
data, load it into the port, build its indexes, warm the cell's own
statements)."""


def read(run):
    return run.setup_s
