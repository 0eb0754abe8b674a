"""APS plan: the partitions a query scans, after the plan's clip and
budget: the mean of SearchTimingInfo.scanned_per_query over every query of
the measured window's calls."""

from benchmark import core


def read(r):
    v = [c["depth"] for c in r.calls if c.get("depth") is not None]
    return core.mean(v) if v else None
