"""Seconds from the process's start to the window's: imports, data and
encoding, plan build and staging, kernel builds, warm-up."""


def read(run):
    return run.setup_s
