"""The window over the ``step()`` calls in it, in ms a step."""


def read(rec):
    return 1e3 * rec.window_s / rec.steps if rec.steps else None
