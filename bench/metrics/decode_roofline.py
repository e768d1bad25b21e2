"""The window's share of the decode's roofline: the least time the card
could take for every operation (each compressed payload byte read once and
each decoded byte written once, at the published memory bandwidth), over
the device time of every kernel, copy and set the trace shows, in %."""
from bench import roofline


def read(run):
    if not run.trace or not run.records or run.trace["device_s"] <= 0:
        return None
    least = sum(roofline.least_seconds(run.queries[r.query])
                for r in run.records)
    return 100.0 * least / run.trace["device_s"]
