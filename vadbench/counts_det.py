"""FLOPs of the Cascade R-CNN R101-FPN's test-time forward on one frame,
from the published shapes of mmdetection v1's cascade_rcnn_r101_fpn_1x
(fore_det/obj_det_config/cascade_rcnn_r101_fpn_1x.py) alone: the
yardstick that `mfu_det.*` divides by. Nothing here reads the program.

Counting rules are vadbench/counts.py's (2 FLOPs a multiply-add, every
tap of a convolution, BatchNorm, activations, pooling, the resize, the
sorts and the NMS left out). Shapes:
  * the frame keep-ratio rescaled to (1333, 800) and padded to /32 (a
    480 x 856 frame: 747 x 1333 on a 768 x 1344 canvas);
  * ResNet-101 (pytorch style, blocks 3-4-23-3, widths 64-128-256-512
    times 4 out) from the 7x7 stride-2 stem: C2..C5 at strides 4..32;
  * the FPN: 1x1 laterals to 256 and 3x3 smoothing convs at P2..P5 (P6
    by max-pool, uncounted);
  * the RPN head on P2..P6: a 3x3 conv 256 -> 256, 1x1 convs to 3 and 12;
  * three stages over 1,000 RoIs each: fc 12,544 -> 1,024, 1,024 ->
    1,024, 1,024 -> 81 and 1,024 -> 4.
"""

from __future__ import annotations

from typing import List, Tuple

from vadbench import counts

RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
FPN_CHANNELS = 256
FC_CHANNELS = 1024
NUM_CLASSES = 81
ROI_SIZE = 7
ANCHORS = 3


def canvas(frame_hw, img_scale=(1333, 800), divisor: int = 32) -> Tuple[int, int]:
    """The padded network input of a frame (mmcv's keep-ratio rescale)."""
    h, w = frame_hw
    scale = min(img_scale[0] / max(h, w), img_scale[1] / min(h, w))
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    return -(-nh // divisor) * divisor, -(-nw // divisor) * divisor


def _half(n: int) -> int:
    return (n + 1) // 2


def resnet_flops(depth: int, h: int, w: int) -> Tuple[float, List[Tuple[int, int, int]]]:
    """ResNet-`depth` on an h x w input: (FLOPs, [(channels, h, w) of
    C2..C5])."""
    h, w = _half(h), _half(w)
    total = counts.conv_flops(3, 64, 7, h, w)  # stem, stride 2
    h, w = _half(h), _half(w)  # max-pool, stride 2
    inplanes, planes, outs = 64, 64, []
    for stage, n in enumerate(RESNET_BLOCKS[depth]):
        for k in range(n):
            cin = inplanes if k == 0 else 4 * planes
            h_in, w_in = h, w
            if k == 0 and stage > 0:
                h, w = _half(h), _half(w)
            total += counts.conv_flops(cin, planes, 1, h_in, w_in)
            total += counts.conv_flops(planes, planes, 3, h, w)
            total += counts.conv_flops(planes, 4 * planes, 1, h, w)
            if k == 0:
                total += counts.conv_flops(cin, 4 * planes, 1, h, w)
        outs.append((4 * planes, h, w))
        inplanes, planes = 4 * planes, 2 * planes
    return total, outs


def fpn_flops(levels) -> float:
    return sum(counts.conv_flops(c, FPN_CHANNELS, 1, h, w)
               + counts.conv_flops(FPN_CHANNELS, FPN_CHANNELS, 3, h, w) for c, h, w in levels)


def rpn_flops(sizes) -> float:
    return sum(counts.conv_flops(FPN_CHANNELS, FPN_CHANNELS, 3, h, w)
               + counts.conv_flops(FPN_CHANNELS, ANCHORS + 4 * ANCHORS, 1, h, w)
               for h, w in sizes)


def stages_flops(rois: int = 1000, stages: int = 3) -> float:
    fan = FPN_CHANNELS * ROI_SIZE * ROI_SIZE
    macs = fan * FC_CHANNELS + FC_CHANNELS * FC_CHANNELS + FC_CHANNELS * (NUM_CLASSES + 4)
    return 2.0 * stages * rois * macs


def frame_flops(frame_hw, depth: int = 101, img_scale=(1333, 800), rois: int = 1000) -> float:
    """The whole detector on one frame."""
    h, w = canvas(frame_hw, img_scale)
    total, levels = resnet_flops(depth, h, w)
    total += fpn_flops(levels)
    p6 = (_half(levels[-1][1]), _half(levels[-1][2]))
    total += rpn_flops([(lh, lw) for _, lh, lw in levels] + [p6])
    return total + stages_flops(rois)


def work_flops(work: dict, config: dict) -> float:
    """Model FLOPs of a window's work: det_frames frames through the
    detector and the valid cubes through the ensemble (counts.work_flops)."""
    det = config["detector"]
    total = work.get("det_frames", 0) * frame_flops(
        config["frame_hw"], int(det["depth"]), tuple(det["img_scale"]),
        int(det["test_cfg"]["max_num"]))
    return total + counts.work_flops(work, config["model"], int(config["patch_size"]))
