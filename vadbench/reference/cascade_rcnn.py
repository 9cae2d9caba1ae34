"""Cascade R-CNN R101-FPN at test time (Cai & Vasconcelos, CVPR 2018,
arXiv 1712.00726) as mmdetection v1's cascade_rcnn_r101_fpn_1x config
runs it for VEC_VAD (fore_det/obj_det_config/cascade_rcnn_r101_fpn_1x.py,
fore_det/inference.py), and obj_det's filter and cover suppression
(fore_det/obj_det_with_motion.py), in plain float32 PyTorch, one frame
at a time: the benchmark's copy, held against the program.

Weights are a state dict under mmdet v1's names (`spec` lists every
name, shape and init rule). Per frame:

  * cv2.resize INTER_LINEAR of the uint8 BGR frame in cv2's fixed-point
    arithmetic (11-bit taps, the vector path's vertical rounding), keep
    ratio to (1333, 800), BGR -> RGB, (x - mean) / std, zero pad to /32;
  * ResNet-101 (pytorch style: the stride on the 3x3 conv), every
    BatchNorm frozen: the per-channel affine weight / sqrt(var + 1e-5),
    bias - mean * that;
  * FPN: 1x1 laterals with bias, nearest x2 top-down adds, 3x3 smoothing
    convs, P6 = max_pool(P5, 1, stride 2);
  * RPN on P2-P6: 3 anchors a position (ratios 0.5, 1, 2, scale 8),
    integer-rounded base anchors centred at (s-1)/2, sigmoid scores, the
    nms_pre best a level, delta2bbox (+1 widths, dw/dh clamped at
    |log(16/1000)|, clipped to the resized image), a sequential greedy
    NMS (+1 areas, IoU above the threshold suppresses) keeping nms_post a
    level, then the max_num best over the levels;
  * three stages: RoIAlign v1 of every RoI on its own level only
    (map_roi_levels: floor(log2(sqrt((w+1)(h+1)) / 56 + 1e-6)) in 0..3),
    each output element from its own RoI, 7 x 7 bins of 2 x 2 samples,
    bilinear with zero outside [-1, size]; fc 1024, fc 1024, 81 logits and 4 class-agnostic
    deltas; each stage's boxes regressed with its stds for the next;
  * the stages' mean logits, softmax, the last stage's boxes divided by
    the scale factor (BBoxHead.get_det_bboxes with rescale=True), then the
    multiclass NMS on them: per foreground class the scores above
    score_thr, sequential greedy NMS at 0.5 (+1 areas in the frame's
    pixels), the max_per_img best over the classes;
  * obj_det: scores above ap_score_thr, inclusive area at least
    ap_min_area, del_cover_bboxes at cover_thr, the first max_boxes.

No batching across frames and no fixed-point NMS: the program's are held
against these loops. TF32 stays off (reference_context); `lowp=True`
rounds every convolution's and linear layer's operands to TF32 for the
control.

Departures from mmdet v1: ties in a score order go to the lower index
(a stable sort; mmdet's topk and sort leave them unspecified); the
multiclass NMS's detections are ordered by score even when fewer than
max_per_img are kept (mmdet v1 sorts only to cut); detections past
max_boxes are cut in del_cover_bboxes' order (obj_det keeps them all).
Unchecked: RoIAlign's box starts at x1 * scale with extent
max((x2 - x1) * scale, 1), the JAX package's reading of mmdet v1's
kernel, which no source in this repository settles; a COCO checkpoint
with mmdet's own outputs would.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vadbench.reference.ops import conv, tf32

RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
NUM_CLASSES = 81  # background + 80 COCO classes
PERSON = 1  # COCO's person, after the background logit
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
ANCHOR_SCALE = 8.0
ANCHOR_STRIDES = (4, 8, 16, 32, 64)
ROI_STRIDES = (4, 8, 16, 32)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (0.033, 0.033, 0.067, 0.067))
IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)  # RGB
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)
TEST_CFG = {"nms_pre": 1000, "nms_post": 1000, "max_num": 1000, "rpn_nms_thr": 0.7,
            "score_thr": 0.05, "rcnn_nms_thr": 0.5, "max_per_img": 100}


# -- the state dict ----------------------------------------------------------


def spec(depth: int = 101) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init rule) of every leaf under mmdet v1's names
    (traffic.weights' rules): convolution and fc weights with variance
    1 / fan_in, biases in +-0.1, frozen BatchNorm statistics drawn."""
    out = []

    def w(name, shape):
        fan = int(np.prod(shape[1:]))
        out.append((f"{name}.weight", tuple(shape), f"xavier:{math.sqrt(3.0 / fan)}"))

    def b(name, n):
        out.append((f"{name}.bias", (n,), "xavier:0.1"))

    def bn(name, c):
        for leaf, rule in (("weight", "bn_scale"), ("bias", "bn_shift"),
                           ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            out.append((f"{name}.{leaf}", (c,), rule))

    w("backbone.conv1", (64, 3, 7, 7))
    bn("backbone.bn1", 64)
    inplanes, planes = 64, 64
    for s, n in enumerate(RESNET_BLOCKS[depth]):
        for k in range(n):
            p = f"backbone.layer{s + 1}.{k}"
            cin = inplanes if k == 0 else 4 * planes
            w(f"{p}.conv1", (planes, cin, 1, 1))
            bn(f"{p}.bn1", planes)
            w(f"{p}.conv2", (planes, planes, 3, 3))
            bn(f"{p}.bn2", planes)
            w(f"{p}.conv3", (4 * planes, planes, 1, 1))
            bn(f"{p}.bn3", 4 * planes)
            if k == 0:
                w(f"{p}.downsample.0", (4 * planes, cin, 1, 1))
                bn(f"{p}.downsample.1", 4 * planes)
        inplanes, planes = 4 * planes, 2 * planes
    for i, c in enumerate((256, 512, 1024, 2048)):
        w(f"neck.lateral_convs.{i}.conv", (256, c, 1, 1))
        b(f"neck.lateral_convs.{i}.conv", 256)
    for i in range(4):
        w(f"neck.fpn_convs.{i}.conv", (256, 256, 3, 3))
        b(f"neck.fpn_convs.{i}.conv", 256)
    A = len(ANCHOR_RATIOS)
    for name, o, k in (("rpn_conv", 256, 3), ("rpn_cls", A, 1), ("rpn_reg", 4 * A, 1)):
        w(f"rpn_head.{name}", (o, 256, k, k))
        b(f"rpn_head.{name}", o)
    for i in range(3):
        p = f"bbox_head.{i}"
        for name, o, fan in (("shared_fcs.0", 1024, 256 * 49), ("shared_fcs.1", 1024, 1024),
                             ("fc_cls", NUM_CLASSES, 1024), ("fc_reg", 4, 1024)):
            w(f"{p}.{name}", (o, fan))
            b(f"{p}.{name}", o)
    return out


# -- the input ---------------------------------------------------------------


def rescale_shape(h: int, w: int, img_scale=(1333, 800)) -> Tuple[int, int, float]:
    """mmcv's keep-ratio rescale: (new h, new w, scale factor)."""
    scale = min(img_scale[0] / max(h, w), img_scale[1] / min(h, w))
    return int(h * scale + 0.5), int(w * scale + 0.5), scale


def _cv2_taps(src: int, dst: int, clamp: bool):
    """cv2 INTER_LINEAR's taps along an axis: the source index of each
    output from the float position (dst + 0.5) * src / dst - 0.5, and
    its two 11-bit weights; the x axis (clamp) moves a tap past either
    border onto the edge pixel with weights (2048, 0)."""
    pos = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0.astype(np.float32)).astype(np.float32)
    if clamp:
        low, high = i0 < 0, i0 >= src - 1
        frac[low | high] = 0.0
        i0[low] = 0
        i0[high] = src - 1
    a0 = np.rint((np.float32(1) - frac) * np.float32(2048)).astype(np.int64)
    a1 = np.rint(frac * np.float32(2048)).astype(np.int64)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), a0, a1


def cv2_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(img, (out_w, out_h), INTER_LINEAR) of a uint8 (H, W, 3)
    image: the horizontal pass in integers (pixel x weight), the vertical
    ((b0 * (row0 >> 4)) >> 16) + ((b1 * (row1 >> 4)) >> 16), + 2, >> 2."""
    H, W, _ = img.shape
    x0, x1, a0, a1 = _cv2_taps(W, out_w, True)
    y0, y1, b0, b1 = _cv2_taps(H, out_h, False)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    v = (((rows[y0] >> 4) * b0[:, None, None]) >> 16) \
        + (((rows[y1] >> 4) * b1[:, None, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def prepare(frame_bgr: np.ndarray, img_scale, device):
    """One uint8 BGR frame -> ((1, 3, PH, PW) network input, resized
    (h, w), scale factor)."""
    nh, nw, scale = rescale_shape(frame_bgr.shape[0], frame_bgr.shape[1], img_scale)
    rgb = cv2_resize(np.asarray(frame_bgr, np.uint8), nh, nw)[..., ::-1]
    x = (rgb.astype(np.float32) - IMG_MEAN) / IMG_STD
    ph, pw = -(-nh // 32) * 32, -(-nw // 32) * 32
    canvas = np.zeros((ph, pw, 3), np.float32)
    canvas[:nh, :nw] = x
    return (torch.from_numpy(canvas).permute(2, 0, 1)[None].contiguous().to(device),
            (nh, nw), scale)


# -- backbone and FPN ----------------------------------------------------------


def _bn(sd, name, x):
    scale = sd[f"{name}.weight"] / torch.sqrt(sd[f"{name}.running_var"] + 1e-5)
    shift = sd[f"{name}.bias"] - sd[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def backbone(sd, x, depth: int = 101, lowp: bool = False) -> List[torch.Tensor]:
    """C2..C5 of ResNet-`depth` on a (1, 3, H, W) input."""
    h = F.relu(_bn(sd, "backbone.bn1",
                   conv(x, sd["backbone.conv1.weight"], stride=2, pad=3, lowp=lowp)))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    outs = []
    for s, n in enumerate(RESNET_BLOCKS[depth]):
        for k in range(n):
            p = f"backbone.layer{s + 1}.{k}"
            stride = 2 if (k == 0 and s > 0) else 1
            y = F.relu(_bn(sd, f"{p}.bn1", conv(h, sd[f"{p}.conv1.weight"], pad=0, lowp=lowp)))
            y = F.relu(_bn(sd, f"{p}.bn2", conv(y, sd[f"{p}.conv2.weight"], stride=stride,
                                                pad=1, lowp=lowp)))
            y = _bn(sd, f"{p}.bn3", conv(y, sd[f"{p}.conv3.weight"], pad=0, lowp=lowp))
            if k == 0:
                h = _bn(sd, f"{p}.downsample.1", conv(h, sd[f"{p}.downsample.0.weight"],
                                                      stride=stride, pad=0, lowp=lowp))
            h = F.relu(y + h)
        outs.append(h)
    return outs


def fpn(sd, feats: Sequence[torch.Tensor], lowp: bool = False) -> List[torch.Tensor]:
    """P2..P6 from C2..C5."""
    lat = [conv(f, sd[f"neck.lateral_convs.{i}.conv.weight"],
                sd[f"neck.lateral_convs.{i}.conv.bias"], pad=0, lowp=lowp)
           for i, f in enumerate(feats)]
    for i in range(len(lat) - 1, 0, -1):
        lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], scale_factor=2, mode="nearest")
    outs = [conv(x, sd[f"neck.fpn_convs.{i}.conv.weight"], sd[f"neck.fpn_convs.{i}.conv.bias"],
                 pad=1, lowp=lowp) for i, x in enumerate(lat)]
    outs.append(F.max_pool2d(outs[-1], 1, stride=2))
    return outs


def pyramid(sd, x, depth: int = 101, lowp: bool = False) -> List[torch.Tensor]:
    return fpn(sd, backbone(sd, x, depth, lowp), lowp)


# -- boxes -------------------------------------------------------------------------


def grid_anchors(stride: int, h: int, w: int, device) -> torch.Tensor:
    """(h * w * 3, 4) anchors, position-major: mmdet v1's base anchors
    (ratios' widths and heights from the stride at scale 8, centred at
    ((s - 1) / 2, (s - 1) / 2), rounded) shifted by the stride."""
    c = 0.5 * (stride - 1)
    hr = np.sqrt(np.asarray(ANCHOR_RATIOS))
    ws = stride * (1.0 / hr) * ANCHOR_SCALE
    hs = stride * hr * ANCHOR_SCALE
    base = np.round(np.stack([c - 0.5 * (ws - 1), c - 0.5 * (hs - 1),
                              c + 0.5 * (ws - 1), c + 0.5 * (hs - 1)], -1))
    ys, xs = np.meshgrid(np.arange(h) * stride, np.arange(w) * stride, indexing="ij")
    shifts = np.stack([xs, ys, xs, ys], -1).reshape(-1, 1, 4)
    return torch.from_numpy((shifts + base[None]).reshape(-1, 4).astype(np.float32)).to(device)


def delta2bbox(rois, deltas, stds, max_hw):
    """mmdet v1 delta2bbox with means 0: +1 widths, dw and dh clamped."""
    d = deltas * torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    clip = abs(math.log(16.0 / 1000.0))
    dx, dy = d[:, 0], d[:, 1]
    dw, dh = d[:, 2].clamp(-clip, clip), d[:, 3].clamp(-clip, clip)
    px = (rois[:, 0] + rois[:, 2]) * 0.5
    py = (rois[:, 1] + rois[:, 3]) * 0.5
    pw = rois[:, 2] - rois[:, 0] + 1.0
    ph = rois[:, 3] - rois[:, 1] + 1.0
    gw, gh = pw * dw.exp(), ph * dh.exp()
    gx, gy = px + pw * dx, py + ph * dy
    h, w = max_hw
    return torch.stack([(gx - gw * 0.5 + 0.5).clamp(0, w - 1),
                        (gy - gh * 0.5 + 0.5).clamp(0, h - 1),
                        (gx + gw * 0.5 - 0.5).clamp(0, w - 1),
                        (gy + gh * 0.5 - 0.5).clamp(0, h - 1)], 1)


def sort_desc(scores: torch.Tensor) -> torch.Tensor:
    """Indices by descending score, ties to the lower index."""
    return torch.sort(scores, descending=True, stable=True)[1]


def nms(boxes: torch.Tensor, scores: torch.Tensor, thr: float) -> torch.Tensor:
    """mmdet v1's greedy NMS, one candidate at a time: in descending score
    order each box not yet suppressed is kept and suppresses every later
    box whose IoU with it (+1 areas) exceeds thr. Returns the kept
    indices into `boxes` in that order."""
    order = sort_desc(scores)
    b = boxes[order]
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    iw = (torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None]) + 1)
    ih = (torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None]) + 1)
    inter = iw.clamp_min(0) * ih.clamp_min(0)
    over = (inter / (area[:, None] + area[None] - inter) > thr).cpu().numpy()
    dead = np.zeros(len(order), bool)
    keep = []
    for i in range(len(order)):
        if dead[i]:
            continue
        keep.append(i)
        dead |= over[i]
    return order[torch.as_tensor(keep, dtype=torch.long, device=order.device)]


# -- the RPN -------------------------------------------------------------------------


def rpn_head(sd, feat, lowp: bool = False):
    """(cls (1, 3, h, w), reg (1, 12, h, w)) of one level."""
    h = F.relu(conv(feat, sd["rpn_head.rpn_conv.weight"], sd["rpn_head.rpn_conv.bias"],
                    pad=1, lowp=lowp))
    return (conv(h, sd["rpn_head.rpn_cls.weight"], sd["rpn_head.rpn_cls.bias"], pad=0, lowp=lowp),
            conv(h, sd["rpn_head.rpn_reg.weight"], sd["rpn_head.rpn_reg.bias"], pad=0, lowp=lowp))


def proposals(heads, img_hw, cfg: Optional[dict] = None) -> torch.Tensor:
    """(n, 4) proposals of one frame from its five levels' (cls, reg)."""
    cfg = {**TEST_CFG, **(cfg or {})}
    boxes, scores = [], []
    for (cls, reg), stride in zip(heads, ANCHOR_STRIDES):
        h, w = cls.shape[2:]
        s = torch.sigmoid(cls[0].permute(1, 2, 0).reshape(-1))
        d = reg[0].permute(1, 2, 0).reshape(-1, 4)
        top = sort_desc(s)[: cfg["nms_pre"]]
        b = delta2bbox(grid_anchors(stride, h, w, cls.device)[top], d[top],
                       (1.0, 1.0, 1.0, 1.0), img_hw)
        keep = nms(b, s[top], cfg["rpn_nms_thr"])[: cfg["nms_post"]]
        boxes.append(b[keep])
        scores.append(s[top][keep])
    boxes, scores = torch.cat(boxes), torch.cat(scores)
    return boxes[sort_desc(scores)[: cfg["max_num"]]]


# -- the stages ----------------------------------------------------------------------------


def roi_levels(rois: torch.Tensor) -> torch.Tensor:
    """map_roi_levels: floor(log2(sqrt(+1 area) / 56 + 1e-6)) in 0..3."""
    scale = torch.sqrt((rois[:, 2] - rois[:, 0] + 1) * (rois[:, 3] - rois[:, 1] + 1))
    return torch.floor(torch.log2(scale / 56.0 + 1e-6)).clamp(0, 3).long()


def _taps(v: torch.Tensor, n: int):
    """mmdet v1 bilinear_interpolate's taps of sample positions v on an
    axis of n pixels: (low, high, fraction, outside [-1, n])."""
    outside = (v < -1.0) | (v > n)
    v = v.clamp(min=0.0)
    lo = v.floor().long()
    edge = lo >= n - 1
    lo = torch.where(edge, n - 1, lo)
    hi = torch.where(edge, n - 1, lo + 1)
    v = torch.where(edge, lo.float(), v)
    return lo, hi, v - lo, outside


def roi_align_level(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
                    out: int = 7, sample_num: int = 2, chunk: int = 128) -> torch.Tensor:
    """RoIAlign v1 of n RoIs on one map (C, H, W) -> (n, C, out, out), as
    mmdet v1's kernel computes each output element from its own RoI: bin
    (ph, pw) averages the samples at start + p * bin + (i + 0.5) * bin / n
    (start x1 * scale, extent max((x2 - x1) * scale, 1)), each bilinear
    with zero outside [-1, size] and clamped to the edge inside."""
    C, H, W = feat.shape
    S = sample_num
    p = torch.arange(out, dtype=torch.float32, device=feat.device)[None, :, None]
    i = torch.arange(S, dtype=torch.float32, device=feat.device)[None, None, :]
    outs = []
    for lo in range(0, rois.shape[0], chunk):
        r = rois[lo:lo + chunk]
        n = r.shape[0]
        x1, y1 = r[:, 0] * spatial_scale, r[:, 1] * spatial_scale
        bw = torch.clamp(r[:, 2] * spatial_scale - x1, min=1.0) / out
        bh = torch.clamp(r[:, 3] * spatial_scale - y1, min=1.0) / out
        ys = (y1[:, None, None] + p * bh[:, None, None]
              + (i + 0.5) * bh[:, None, None] / S).reshape(n, out * S)
        xs = (x1[:, None, None] + p * bw[:, None, None]
              + (i + 0.5) * bw[:, None, None] / S).reshape(n, out * S)
        y0, y1i, ly, oy = _taps(ys, H)
        x0, x1i, lx, ox = _taps(xs, W)
        hy, hx = 1.0 - ly, 1.0 - lx

        def at(yy, xx):  # (C, n, out*S, out*S)
            return feat[:, yy[:, :, None], xx[:, None, :]]

        val = (at(y0, x0) * (hy[:, :, None] * hx[:, None, :])
               + at(y0, x1i) * (hy[:, :, None] * lx[:, None, :])
               + at(y1i, x0) * (ly[:, :, None] * hx[:, None, :])
               + at(y1i, x1i) * (ly[:, :, None] * lx[:, None, :]))
        val = torch.where((oy[:, :, None] | ox[:, None, :])[None], 0.0, val)
        val = val.reshape(C, n, out, S, out, S).sum((3, 5)) / (S * S)
        outs.append(val.permute(1, 0, 2, 3))
    return torch.cat(outs)


def roi_align(levels: Sequence[torch.Tensor], rois: torch.Tensor) -> torch.Tensor:
    """(n, 256, 7, 7): every RoI aligned on its own level of one frame's
    P2..P5 ((1, C, h, w) each) only, level by level as mmdet v1's
    SingleRoIExtractor calls the kernel."""
    lvl = roi_levels(rois)
    out = rois.new_zeros((rois.shape[0], levels[0].shape[1], 7, 7))
    for k, stride in enumerate(ROI_STRIDES):
        idx = torch.nonzero(lvl == k).reshape(-1)
        if idx.numel():
            out[idx] = roi_align_level(levels[k][0], rois[idx], 1.0 / stride)
    return out


def _linear(x, w, b, lowp):
    if lowp:
        x, w = tf32(x), tf32(w)
    return F.linear(x, w, b)


def stage_head(sd, stage: int, levels, rois, lowp: bool = False):
    """(logits (n, 81), deltas (n, 4)) of cascade stage `stage` at `rois`."""
    p = f"bbox_head.{stage}"
    h = roi_align(levels, rois).flatten(1)
    for fc in ("shared_fcs.0", "shared_fcs.1"):
        h = F.relu(_linear(h, sd[f"{p}.{fc}.weight"], sd[f"{p}.{fc}.bias"], lowp))
    return (_linear(h, sd[f"{p}.fc_cls.weight"], sd[f"{p}.fc_cls.bias"], lowp),
            _linear(h, sd[f"{p}.fc_reg.weight"], sd[f"{p}.fc_reg.bias"], lowp))


def cascade(sd, levels, rois, img_hw, lowp: bool = False) -> dict:
    """The three stages from one frame's proposals: each stage's rois,
    logits and deltas, the final boxes and the softmax of the mean
    logits."""
    out = {"rois": [], "logits": [], "deltas": []}
    for stage in range(3):
        logits, deltas = stage_head(sd, stage, levels, rois, lowp)
        out["rois"].append(rois)
        out["logits"].append(logits)
        out["deltas"].append(deltas)
        if stage < 2:
            rois = delta2bbox(rois, deltas, STAGE_STDS[stage], img_hw)
    out["bboxes"] = delta2bbox(rois, out["deltas"][-1], STAGE_STDS[-1], img_hw)
    out["scores"] = torch.softmax(sum(out["logits"]) / 3.0, dim=1)
    return out


def multiclass_nms(bboxes, scores, score_thr: float = 0.05, nms_thr: float = 0.5,
                   max_per_img: int = 100):
    """(boxes (k, 4), scores (k,), labels (k,)) of one frame: per
    foreground class its scores above score_thr, NMS, then the
    max_per_img best (ties: lower class, then NMS order); labels 0-based."""
    boxes, kept, labels = [], [], []
    for c in range(1, scores.shape[1]):
        sel = torch.nonzero(scores[:, c] > score_thr).reshape(-1)
        if sel.numel() == 0:
            continue
        keep = sel[nms(bboxes[sel], scores[sel, c], nms_thr)]
        boxes.append(bboxes[keep])
        kept.append(scores[keep, c])
        labels.append(torch.full((keep.numel(),), c - 1, dtype=torch.long,
                                 device=keep.device))
    if not boxes:
        z = bboxes.new_zeros((0,))
        return bboxes.new_zeros((0, 4)), z, z.long()
    boxes, kept, labels = torch.cat(boxes), torch.cat(kept), torch.cat(labels)
    top = sort_desc(kept)[:max_per_img]
    return boxes[top], kept[top], labels[top]


def det_bboxes(bboxes, scores, scale: float, cfg: Optional[dict] = None):
    """BBoxHead.get_det_bboxes (v1, rescale=True) of one frame's final
    boxes (resized coordinates) and scores: the boxes divided by the scale
    factor, then multiclass_nms. (boxes in the frame's coordinates,
    scores, labels)."""
    cfg = {**TEST_CFG, **(cfg or {})}
    return multiclass_nms(bboxes / scale, scores, cfg["score_thr"], cfg["rcnn_nms_thr"],
                          cfg["max_per_img"])


# -- obj_det's filter ------------------------------------------------------------------------


def filter_boxes(boxes: np.ndarray, scores: np.ndarray, score_thr: float,
                 min_area: float) -> np.ndarray:
    """obj_det_with_motion.py's appearance filter: score above the
    threshold, then (x2 - x1 + 1) * (y2 - y1 + 1) at least min_area."""
    b = np.asarray(boxes).reshape(-1, 4)[np.asarray(scores).reshape(-1) > score_thr]
    return b[(b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1) >= min_area]


def del_cover(boxes: np.ndarray, cover_thr: float) -> np.ndarray:
    """obj_det_with_motion.py's del_cover_bboxes: boxes by ascending area;
    one is dropped when some later (larger) box covers more than cover_thr
    of its own +1 area."""
    if boxes.shape[0] == 0:
        return boxes.reshape(0, 4)
    x1, y1, x2, y2 = boxes.T
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = area.argsort()
    keep = []
    for i, a in enumerate(order):
        later = order[i + 1:]
        iw = np.maximum(0, np.minimum(x2[a], x2[later]) - np.maximum(x1[a], x1[later]) + 1)
        ih = np.maximum(0, np.minimum(y2[a], y2[later]) - np.maximum(y1[a], y1[later]) + 1)
        if not np.any(iw * ih / area[a] > cover_thr):
            keep.append(a)
    return boxes[keep]


def kept_boxes(boxes, scores, spec: dict, max_boxes: int) -> np.ndarray:
    """One frame's detections (the frame's coordinates, torch) -> obj_det's
    boxes: filtered, suppressed, the first max_boxes."""
    ap = filter_boxes(boxes.cpu().numpy(), scores.cpu().numpy(), spec["ap_score_thr"],
                      spec["ap_min_area"])
    return del_cover(ap, spec["cover_thr"])[:max_boxes]


# -- one frame end to end ---------------------------------------------------------------------------


def detect(sd, frame_bgr: np.ndarray, depth: int = 101, img_scale=(1333, 800),
           cfg: Optional[dict] = None, lowp: bool = False) -> Dict[str, object]:
    """The whole test-time path on one frame: every intermediate (pyramid,
    heads, proposals, the stages' rois, logits and deltas, bboxes,
    scores), the detections (boxes in the frame's coordinates, scores,
    labels) and the scale."""
    cfg = {**TEST_CFG, **(cfg or {})}
    dev = next(iter(sd.values())).device
    x, img_hw, scale = prepare(frame_bgr, img_scale, dev)
    pyr = pyramid(sd, x, depth, lowp)
    heads = [rpn_head(sd, p, lowp) for p in pyr]
    props = proposals(heads, img_hw, cfg)
    out = cascade(sd, pyr[:4], props, img_hw, lowp)
    b, s, l = det_bboxes(out["bboxes"], out["scores"], scale, cfg)
    out.update(pyramid=pyr, heads=heads, proposals=props, img_hw=img_hw, scale=scale,
               detections=(b.cpu().numpy(), s.cpu().numpy(), l.cpu().numpy()))
    return out
