"""Device milliseconds of the detector's forward (one a tick: the fleet's
C frames), between CUDA events that forward pre- and post-hooks on the
detector module the route calls record (the region the program's
serve.detect span brackets, less the download and the host's filter);
the mean over the traced window."""


def read(rec, name):
    ms = rec["driver"].get("detect_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
