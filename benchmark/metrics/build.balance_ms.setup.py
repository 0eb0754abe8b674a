"""Build: host ms of the balancing's split rounds (BuildTimingInfo's
balance_time_us, kmeans.balance_clusters on the host), in set-up."""


def read(r):
    b = getattr(r, "build", None)
    return b["balance_time_us"] * 1e-3 if b and "balance_time_us" in b else None
