"""Device: the share of the traced window in which no operation ran on the
device, in %. Serves `device.idle_pct.search` and `device.idle_pct.churn`
(one quantity, named apart by the end-to-end metric it moves)."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or r.trace.n_device_events == 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
