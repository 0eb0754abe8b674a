"""Search plan: mean host ms a search call takes to enqueue its launches
(SearchTimingInfo's job_enqueue, the quake.dispatch phase), over the
measured window's calls."""

from benchmark import core


def read(r):
    v = [c["enqueue_ms"] for c in r.calls if c.get("enqueue_ms") is not None]
    return core.mean(v) if v else None
