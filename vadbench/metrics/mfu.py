"""The whole step's share of the card's float32 peak (67 TFLOP/s, CUDA
cores; the configurations run f32 with TF32 off): model FLOPs of the
traced window's work, counted from published layer shapes
(vadbench/counts.py: valid cubes only, FlowNet2 pairs, 3x the forward for
a training step), over the window times the peak."""

from vadbench import counts


def read(rec, name):
    if rec["summary"] is None or rec["window_s"] <= 0:
        return None
    cfg = rec["config"]
    flow_hw = tuple(cfg.get("flow", {}).get("model_hw", (384, 512)))
    flops = counts.work_flops(rec["work"], cfg["model"], int(cfg["patch_size"]), flow_hw)
    if flops <= 0:
        return None
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_FLOPS["float32"])
