"""Kernels the trace shows, over the window's operations."""


def read(run):
    if not run.trace or not run.records:
        return None
    return run.trace["kernels"] / len(run.records)
