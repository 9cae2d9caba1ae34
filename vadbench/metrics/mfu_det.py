"""The whole detecting step's share of the card's float32 peak (67
TFLOP/s; f32 with TF32 off): the detector's FLOPs a frame from published
shapes (vadbench/counts_det.py) times the frames detected, plus the
ensemble's over the valid cubes (vadbench/counts.py), over the traced
window times the peak."""

from vadbench import counts, counts_det


def read(rec, name):
    if rec["summary"] is None or rec["window_s"] <= 0 or not rec["work"].get("det_frames"):
        return None
    flops = counts_det.work_flops(rec["work"], rec["config"])
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_FLOPS["float32"])
