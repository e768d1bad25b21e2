"""Host milliseconds from an operation's start to its last launch queued
(the call into the program returning), mean over the window's
operations."""


def read(run):
    if not run.records:
        return None
    return 1e3 * sum(r.queued - r.start for r in run.records) / len(
        run.records)
