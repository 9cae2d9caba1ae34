"""Share of the device's busy time in which a layout conversion ran:
the union of the intervals of cuDNN's transposes between NCHW and NHWC
and its generic tensor transposes (these name patterns,
case-insensitive) over the union of all device intervals."""

PATTERNS = ("genericTranspose", "nchwToNhwc", "nhwcToNchw", "transpose_readWrite",
            "batch_transpose")


def read(rec, name):
    s = rec["summary"]
    if s is None or s.busy_s <= 0:
        return None
    t = s.union_s(*PATTERNS)
    if t <= 0:
        return None
    return 100.0 * t / s.busy_s
