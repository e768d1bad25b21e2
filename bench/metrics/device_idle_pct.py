"""Share of the traced window in which nothing ran on the card, in %."""


def read(run):
    if not run.trace or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.window_s)
