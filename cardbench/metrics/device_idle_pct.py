"""Share of the traced window in which no operation ran on the card."""


def read(rec):
    t = rec.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
