"""The whole step's share of the card's bf16 peak: useful model FLOPs of the
window (harness/loops.py: 2 x active parameters for every token a pass
really scored, prompts unpadded, plus 4 x layers x heads x head_dim for each
key attended) over the traced window's seconds x 989e12."""
from harness.bounds import PEAK_FLOPS


def read(rec):
    if rec.trace is None:
        return None
    return 100.0 * rec.flops / (rec.trace.window_s * PEAK_FLOPS["bfloat16"])
