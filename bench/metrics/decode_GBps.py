"""Decoded bytes the caller receives (after the 64-bit planes are joined),
over every operation of the window, per second of the window; GB = 1e9."""


def read(run):
    if not run.records or run.window_s <= 0:
        return None
    total = sum(run.queries[r.query].user_bytes for r in run.records)
    return total / run.window_s / 1e9
