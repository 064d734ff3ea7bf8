"""Tokens a stream gains a speculative block: (accepted + blocks) / blocks
from the engine's counters over the window."""


def read(rec):
    blocks = rec.delta("blocks")
    return (rec.delta("accepted") + blocks) / blocks if blocks else None
