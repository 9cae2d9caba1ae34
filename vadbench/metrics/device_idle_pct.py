"""Share of the traced window in which no operation ran on the device:
100 * (1 - union of device intervals / window)."""


def read(rec, name):
    s = rec["summary"]
    if s is None or s.busy_s <= 0 or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / rec["window_s"])
