"""Kernel records of the device trace in the window (copies and fills left
out) over the window's steps."""


def read(rec):
    if rec.trace is None or not rec.steps:
        return None
    return rec.trace.kernels / rec.steps
