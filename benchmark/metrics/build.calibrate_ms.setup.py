"""Build: host ms of the APS calibration (BuildTimingInfo's
calibrate_time_us, calibrate_aps, ending in a sync on the card), in
set-up."""


def read(r):
    b = getattr(r, "build", None)
    return b["calibrate_time_us"] * 1e-3 if b and "calibrate_time_us" in b else None
