"""Device milliseconds a tick of the greedy-NMS scan kernel (csrc/nms_scan.cu):
the device time of the kernels named `nms_scan` over the traced window,
over the ticks (each detector forward launches it twice: the RPN's scan
and the multiclass step's). The scan is latency-bound (one barrier a
kept candidate), so its time, not a share of a memory roofline, is what
it is read by."""

KERNEL = "nms_scan"


def read(rec, name):
    s = rec["summary"]
    if s is None:
        return None
    t, n = s.kernel_s(KERNEL)
    if n == 0 or t <= 0:
        return None
    return 1e3 * t / (n / 2)
