"""Index API: mean host ms a search call spends copying the queries to the
device and the results back (SearchTimingInfo's buffer_init plus
result_aggregate), over the measured window's calls."""

from benchmark import core


def read(r):
    v = [c["buffer_init_ms"] + c["aggregate_ms"] for c in r.calls
         if c.get("buffer_init_ms") is not None and c.get("aggregate_ms") is not None]
    return core.mean(v) if v else None
