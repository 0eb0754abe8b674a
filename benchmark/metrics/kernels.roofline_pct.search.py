"""Kernels: the traced calls' roofline bound (benchmark/roofline.py: the
work the inputs need, at the card's peak) as a share of the device's busy
time over them, in %."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0 or r.bound_s <= 0:
        return None
    return 100.0 * r.bound_s / r.trace.busy_s
