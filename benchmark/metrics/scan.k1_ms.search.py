"""Grouped scan: device ms per search call of the kernels named
grouped_scan* (K1), in the traced window."""


def read(r):
    if r.trace is None or not r.traced_calls:
        return None
    s = r.trace.op_seconds("grouped_scan")
    return s * 1e3 / r.traced_calls if s > 0 else None
