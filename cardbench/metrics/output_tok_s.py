"""Tokens that ``step()`` returned to callers in the window (each request's
up to its ``max_new``), over the window's seconds."""
from harness.stats import rate


def read(rec):
    return rate(rec.tokens, rec.window_s)
