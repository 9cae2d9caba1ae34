"""K1's share of its roofline: the least time FlowNetC's cost volume can
take on the card at the served shape (batch = the fleet's cameras, conv3
features at the model size), times its launches, over the device time of
the kernels named `corr_fwd` (csrc/correlation.cu's kernels)."""

from vadbench import counts

KERNEL = "corr_fwd"


def read(rec, name):
    s, batch = rec["summary"], rec["driver"].get("k1_batch")
    if s is None or not batch:
        return None
    t, n = s.kernel_s(KERNEL)
    if n == 0 or t <= 0:
        return None
    h, w = rec["config"]["flow"]["model_hw"]
    bound, _ = counts.correlation_bound_s(counts.flownet_c_corr_shape(batch, h, w))
    return 100.0 * bound * n / t
