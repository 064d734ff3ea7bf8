"""The tree kernels' share of their roofline: the least time of every
recorded call (harness/bounds.py) over the device time of those kernels."""


def read(rec):
    t = rec.trace
    if t is None or t.tree_kernel_s <= 0:
        return None
    return 100.0 * t.tree_least_s / t.tree_kernel_s
