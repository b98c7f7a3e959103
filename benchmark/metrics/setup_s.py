"""setup_s: process start to the first frame submitted in the window."""


def read(run):
    return run.setup_s
