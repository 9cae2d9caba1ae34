"""Device milliseconds of a FlowNet2 forward (one a tick: the fleet's C
pairs), between CUDA events that forward pre- and post-hooks on the
harness's FlowNet2 instance record; the mean over the traced window."""


def read(rec, name):
    ms = rec["driver"].get("flownet2_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
