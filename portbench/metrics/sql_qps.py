"""Statements answered without error inside the window, all clients,
divided by the window."""


def read(run):
    return run.rate()
