"""Build: host ms of the build's k-means (training and the full
assignment: BuildTimingInfo's train_time_us less its balance_time_us), in
set-up."""


def read(r):
    b = getattr(r, "build", None)
    if not b or "balance_time_us" not in b:
        return None
    return (b["train_time_us"] - b["balance_time_us"]) * 1e-3
