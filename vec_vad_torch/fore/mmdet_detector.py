"""mmdet v1 CascadeRCNN test-time detection path on the card
(vec_vad_tpu/fore/mmdet_detector.py).

With a checkpoint loaded by key (fore/mmdet_import.load_mmdet_state),
`MMDetCascadeDetector` reproduces the reference's
`inference_detector(model, img)` pipeline (fore_det/inference.py:97-123)
for the cascade_rcnn_r101_fpn_1x config: RPN proposals, RoIAlign over
the FPN pyramid, three cascade refinement stages, multiclass NMS.

The numerics are the mmdet v1 *legacy* conventions, load-bearing for
checkpoint parity:

  * base anchors are rounded to integer coords; w = stride, centred at
    (stride-1)/2 (mmdet/core/anchor/anchor_generator.py, v1).
  * delta2bbox uses the +1 width convention (pw = x2-x1+1) and clamps
    dw/dh at |log(16/1000)| (mmdet/core/bbox/transforms.py, v1).
  * NMS IoU uses +1 areas (mmdet/ops/nms, v1 CPU kernel).
  * RoIAlign is Caffe2-style aligned=False: no half-pixel offset,
    roi size floored at 1, sample_num=2 regular sub-bins, bilinear with
    zero outside [-1, size] (mmdet/ops/roi_align/src/roi_align_kernel.cu).
  * FPN level for a RoI: floor(log2(sqrt(area+1 style)/56 + 1e-6))
    clamped to [0,3] (SingleRoIExtractor.map_roi_levels).
  * class 0 is BACKGROUND; cascade averages the three stages' cls logits
    before one softmax (mmdet/models/detectors/cascade_rcnn.py simple_test).
  * the final boxes are divided by the scale factor BEFORE the multiclass
    NMS (BBoxHead.get_det_bboxes with rescale=True), so its +1 areas see
    the original frame's pixels. The JAX package runs that NMS on the
    resized image's boxes and divides after; near an IoU of 0.5 the two
    can keep different boxes.

The form suits the card rather than the TPU, with the same results:

  * NMS is sorted greedy NMS over an IoU-over-threshold mask, its scan
    one kernel launch on the card (`greedy_keep`, csrc/nms_scan.cu: a
    thread block walks a row's candidates in order) and a fixed-point
    iteration on the CPU: no host sync per pick (JAX: a scan of
    argmax-pick and suppress steps). It keeps JAX's tie order: a stable
    descending sort is the order the argmax picks in.
    The RPN's five levels (and a batch's frames) are swept together, the
    80 classes of the multiclass step likewise over one shared IoU mask.
  * RoIAlign aligns each RoI on its own level only, gathering from one
    flat channels-last buffer of the four levels (JAX computes every RoI
    on all four levels and selects one).
  * The keep-ratio resize runs on the card in cv2's own fixed-point
    arithmetic (`resize_linear_u8`), so the upload is the uint8 frame and
    the machine needs no cv2.
  * The whole test-time forward, from the uint8 frames on the device to
    the multiclass NMS, is one module call (`CascadeDetect`), so a caller
    can bracket it and hook it; inside it the spans `detect.prep`,
    `detect.backbone`, `detect.rpn`, `detect.stages` and `detect.nms`
    (runtime.profiling.annotate) hold its sections.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vec_vad_torch import kernels
from vec_vad_torch.device import full_f32, resolve_device
from vec_vad_torch.fore.mmdet_import import (
    BackboneFPN,
    FrozenBatchNorm,
    infer_depth,
    load_checkpoint_file,
    load_mmdet_state,
    strip_checkpoint,
)
from vec_vad_torch.runtime.profiling import annotate

ANCHOR_RATIOS = (0.5, 1.0, 2.0)
ANCHOR_SCALES = (8.0,)
ANCHOR_STRIDES = (4, 8, 16, 32, 64)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (0.033, 0.033, 0.067, 0.067))
WH_RATIO_CLIP = 16.0 / 1000.0
FINEST_SCALE = 56.0
NUM_CLASSES = 81  # 80 COCO + background at index 0
ROI_SIZE = 7
ROI_STRIDES = (4, 8, 16, 32)


# ---------------------------------------------------------------------------
# heads (structure + checkpoint naming parity)
# ---------------------------------------------------------------------------


class RPNHead(nn.Module):
    """rpn_head: shared 3x3 conv + 1x1 cls (sigmoid, A anchors) + 1x1 reg."""

    def __init__(self, feat_channels: int = 256,
                 num_anchors: int = len(ANCHOR_RATIOS) * len(ANCHOR_SCALES)):
        super().__init__()
        self.rpn_conv = nn.Conv2d(feat_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, feat):
        h = F.relu(self.rpn_conv(feat))
        return self.rpn_cls(h), self.rpn_reg(h)


class SharedFCBBoxHead(nn.Module):
    """bbox_head.{i}: flatten(256x7x7, torch's order) -> fc1024 -> fc1024
    -> cls81 / reg4 (class-agnostic)."""

    def __init__(self, in_channels: int = 256, fc_out: int = 1024,
                 num_classes: int = NUM_CLASSES):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * ROI_SIZE * ROI_SIZE, fc_out),
            nn.Linear(fc_out, fc_out)])
        self.fc_cls = nn.Linear(fc_out, num_classes)
        self.fc_reg = nn.Linear(fc_out, 4)

    def forward(self, roi_feat):  # (N, 256, 7, 7)
        h = roi_feat.flatten(1)
        for fc in self.shared_fcs:
            h = F.relu(fc(h))
        return self.fc_cls(h), self.fc_reg(h)


class CascadeRCNN(BackboneFPN):
    """The whole cascade_rcnn_*_fpn graph under mmdet v1's checkpoint
    names: backbone.*, neck.*, rpn_head.*, bbox_head.{0,1,2}.*."""

    def __init__(self, depth: int = 101, num_stages: int = 3):
        super().__init__(depth)
        self.rpn_head = RPNHead()
        self.bbox_head = nn.ModuleList([SharedFCBBoxHead() for _ in range(num_stages)])


def random_cascade_state(depth: int = 101, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded random Cascade R-CNN state dict under mmdet v1's names, for
    runs and tests where no COCO checkpoint is at hand: convolution and
    fc weights normal with variance 1/fan_in (activations stay O(1)
    through the 100+ layers), biases uniform in +-0.1, and random frozen
    BN statistics (weight 0.5-1.5, bias +-0.3, mean +-0.5, var 0.3-2.0),
    all drawn from a CPU torch.Generator seeded with `seed`."""
    g = torch.Generator().manual_seed(int(seed))
    model = CascadeRCNN(depth)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.3, 0.3, generator=g)
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.3, 2.0, generator=g)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, 1.0 / m.weight[0].numel() ** 0.5, generator=g)
                if m.bias is not None:
                    m.bias.uniform_(-0.1, 0.1, generator=g)
    return model.state_dict()


# ---------------------------------------------------------------------------
# legacy box numerics
# ---------------------------------------------------------------------------


def base_anchors(stride: int) -> np.ndarray:
    """mmdet v1 AnchorGenerator.gen_base_anchors: +1 centres, rounded."""
    w = h = float(stride)
    xc, yc = 0.5 * (w - 1), 0.5 * (h - 1)
    hr = np.sqrt(np.asarray(ANCHOR_RATIOS))
    wr = 1.0 / hr
    ws = (w * wr[:, None] * np.asarray(ANCHOR_SCALES)[None]).reshape(-1)
    hs = (h * hr[:, None] * np.asarray(ANCHOR_SCALES)[None]).reshape(-1)
    return np.round(np.stack(
        [xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
         xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)], axis=-1)).astype(np.float32)


def grid_anchors(stride: int, feat_h: int, feat_w: int) -> np.ndarray:
    """(H*W*A, 4), shift-major / anchor-minor — matches the head output's
    permute(1,2,0) flattening."""
    base = base_anchors(stride)  # (A, 4)
    sx = np.arange(feat_w, dtype=np.float32) * stride
    sy = np.arange(feat_h, dtype=np.float32) * stride
    shift = np.stack(np.broadcast_arrays(
        sx[None, :], sy[:, None], sx[None, :], sy[:, None]), axis=-1)
    return (shift.reshape(-1, 1, 4) + base[None]).reshape(-1, 4)


@functools.lru_cache(maxsize=64)
def _const(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant on `device`, made once and never written: an upload
    from pageable host memory waits for everything queued on the device,
    which the detector's forward would otherwise do a dozen times a
    call. `values` is a number or a tuple."""
    return torch.tensor(values, dtype=dtype, device=device)


def delta2bbox(rois, deltas, stds, max_hw):
    """mmdet v1 transforms.delta2bbox (legacy +1 widths), means all-zero."""
    d = deltas * _const(tuple(stds), torch.float32, deltas.device)
    max_ratio = abs(float(np.log(WH_RATIO_CLIP)))
    dx, dy = d[..., 0], d[..., 1]
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0] + 1.0
    ph = rois[..., 3] - rois[..., 1] + 1.0
    gw, gh = pw * torch.exp(dw), ph * torch.exp(dh)
    gx, gy = px + pw * dx, py + ph * dy
    h, w = max_hw
    x1 = (gx - 0.5 * (gw - 1)).clamp(0, w - 1)
    y1 = (gy - 0.5 * (gh - 1)).clamp(0, h - 1)
    x2 = (gx + 0.5 * (gw - 1)).clamp(0, w - 1)
    y2 = (gy + 0.5 * (gh - 1)).clamp(0, h - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def iou_plus1(a, b):
    """v1 NMS IoU, +1 areas: (..., N, 4) x (..., M, 4) -> (..., N, M), in
    the JAX package's arithmetic with a the picked box."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (x2 - x1 + 1).clamp_min(0) * (y2 - y1 + 1).clamp_min(0)
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    return inter / (area_a + area_b - inter)


def true_div(x, d: float):
    """x / d with d as a tensor on x's device: given a CPU scalar, the CUDA
    kernel multiplies by d's reciprocal, which can differ from the
    quotient (the CPU's and the JAX package's) in the last bit."""
    return x / _const(float(d), x.dtype, x.device)


def stable_topk(x, k: int):
    """Top k along the last axis, ties in index order (jax.lax.top_k's
    order; torch.topk's is unspecified)."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def greedy_keep(over, valid, check_every: int = 4):
    """Sorted greedy NMS. over (..., K, K): candidate i (in score order)
    suppresses j > i where over[i, j]; valid (..., K). Returns keep
    (..., K): a valid candidate survives unless a surviving earlier one
    suppresses it.

    On the card one launch of csrc/nms_scan.cu walks each row's
    candidates in order (a thread block a row), so its time does not grow
    with the longest chain of suppressions. On the CPU the fixed-point
    iteration keep <- valid & ~(keep @ over): position j is final once
    every position before it is, so it converges, and its fixed point is
    the greedy solution; it checks once per `check_every` iterations."""
    if over.is_cuda:
        return _nms_scan(over, valid)
    return _fixed_point(over, valid, check_every)


def _fixed_point(over, valid, check_every: int = 4):
    """greedy_keep's fixed-point iteration, on any device."""
    K = over.shape[-1]
    upper = torch.ones(K, K, dtype=torch.bool, device=over.device).triu(1)
    sup = (over & upper).to(torch.float32)
    keep = valid
    while True:
        for _ in range(check_every):
            prev = keep
            hit = torch.matmul(keep.to(torch.float32).unsqueeze(-2), sup).squeeze(-2) > 0
            keep = valid & ~hit
        if torch.equal(keep, prev):
            return keep


def _nms_scan(over, valid):
    """greedy_keep on the card: csrc/nms_scan.cu over the rows of the
    leading axes."""
    K = over.shape[-1]
    if over.shape[-2] != K or valid.shape != over.shape[:-1]:
        raise ValueError(f"nms scan: over {tuple(over.shape)}, valid {tuple(valid.shape)}")
    o = over.contiguous().view(torch.uint8)
    v = valid.contiguous().view(torch.uint8)
    keep = torch.empty_like(v)
    kernels.launch("nms_scan", "vv_nms_scan", (o.data_ptr(), v.data_ptr(), keep.data_ptr()),
                   (v.numel() // K, K), over.device)
    return keep.view(torch.bool)


def _first_survivors(keep, n_pick: int):
    """Positions (in order) of the first n_pick survivors of each group and
    whether each slot holds one: (..., n_pick) each."""
    sel = keep & (keep.cumsum(-1) <= n_pick)
    pos = torch.sort((~sel).to(torch.uint8), dim=-1, stable=True)[1][..., :n_pick]
    ok = sel.gather(-1, pos)
    extra = n_pick - pos.shape[-1]  # more slots than candidates: they hold none
    if extra > 0:
        pos = torch.cat([pos, pos.new_zeros(pos.shape[:-1] + (extra,))], -1)
        ok = torch.cat([ok, ok.new_zeros(ok.shape[:-1] + (extra,))], -1)
    return pos, ok


def nms_pick(boxes, scores, iou_thr: float, n_pick: int):
    """Greedy NMS with JAX's nms_pick contract, batched over leading axes:
    (idx (..., n_pick), ok (..., n_pick)): the kept boxes in descending
    score order (ties: lower index first). Invalid candidates carry -inf;
    a slot past the survivors has ok False and idx 0, as the JAX scan's
    argmax over all -inf returns 0."""
    s, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    b = boxes.gather(-2, order[..., None].expand(order.shape + (4,)))
    keep = greedy_keep(iou_plus1(b, b) > iou_thr, s > -torch.inf)
    pos, ok = _first_survivors(keep, n_pick)
    idx = order.gather(-1, pos.clamp(max=order.shape[-1] - 1))
    return torch.where(ok, idx, 0), ok


# ---------------------------------------------------------------------------
# RoIAlign (Caffe2 aligned=False, sample_num=2) over the FPN pyramid
# ---------------------------------------------------------------------------


def _bilinear_rows(flat, base, H, W, yy, xx):
    """mmdet v1 bilinear sample of rows of `flat` (R, C): pixel (y, x) of
    the map starting at row `base` with size (H, W), per sample. yy, xx,
    base, H, W broadcast together; H, W are float32 tensors. Zero outside
    [-1, size], clamped inside. Returns (*shape, C)."""
    oob = (yy < -1.0) | (yy > H) | (xx < -1.0) | (xx > W)
    yy = torch.minimum(yy.clamp_min(0.0), H - 1)
    xx = torch.minimum(xx.clamp_min(0.0), W - 1)
    y0 = torch.floor(yy).to(torch.int64)
    x0 = torch.floor(xx).to(torch.int64)
    Hi, Wi = H.to(torch.int64), W.to(torch.int64)
    y1i = torch.minimum(y0 + 1, Hi - 1)
    x1i = torch.minimum(x0 + 1, Wi - 1)
    ly, lx = yy - y0, xx - x0

    def at(y, x):
        return flat[(base + y * Wi + x).reshape(-1)].reshape(y.shape + (-1,))

    val = (at(y0, x0) * ((1 - ly) * (1 - lx))[..., None]
           + at(y0, x1i) * ((1 - ly) * lx)[..., None]
           + at(y1i, x0) * (ly * (1 - lx))[..., None]
           + at(y1i, x1i) * (ly * lx)[..., None])
    return torch.where(oob[..., None], 0.0, val)


def _sample_grid(boxes, scale, out: int, sample_num: int):
    """mmdet v1's regular sample coords: (N, out, S) each for y and x."""
    x1 = boxes[:, 0] * scale
    y1 = boxes[:, 1] * scale
    w = (boxes[:, 2] * scale - x1).clamp_min(1.0)
    h = (boxes[:, 3] * scale - y1).clamp_min(1.0)
    bin_w, bin_h = true_div(w, out), true_div(h, out)
    s = true_div(torch.arange(sample_num, dtype=torch.float32, device=boxes.device) + 0.5,
                 sample_num)
    grid = torch.arange(out, device=boxes.device)[None, :, None] + s[None, None, :]
    gx = x1[:, None, None] + grid * bin_w[:, None, None]
    gy = y1[:, None, None] + grid * bin_h[:, None, None]
    return gy, gx


def _roi_align_flat(flat, base, H, W, scale, boxes, out: int, sample_num: int):
    """RoIAlign of N boxes, each from its own map in `flat` (per-box base
    row, size and scale): -> (N, C, out, out)."""
    gy, gx = _sample_grid(boxes, scale, out, sample_num)
    N, S = boxes.shape[0], sample_num
    col = lambda t: t[:, None, None, None, None]
    yy = gy[:, :, :, None, None].expand(N, out, S, out, S)
    xx = gx[:, None, None, :, :].expand(N, out, S, out, S)
    vals = _bilinear_rows(flat, col(base), col(H), col(W), yy, xx)
    return vals.mean(dim=(2, 4)).permute(0, 3, 1, 2)


def roi_align_v1(feat, boxes, spatial_scale: float, out: int = ROI_SIZE,
                 sample_num: int = 2):
    """feat (C, H, W), boxes (N, 4) in image coords -> (N, C, out, out).

    mmdet v1 roi_align_kernel.cu semantics: start = x1*scale (no -0.5),
    size floored at 1, sample_num^2 regular samples per bin averaged,
    bilinear with zero outside [-1, size] and edge clamping inside."""
    C, H, W = feat.shape
    flat = feat.permute(1, 2, 0).reshape(H * W, C)
    n = boxes.shape[0]
    dev = feat.device
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    full = lambda v: torch.full((n,), float(v), dtype=torch.float32, device=dev)
    return _roi_align_flat(flat, zero, full(H), full(W), full(spatial_scale),
                           boxes, out, sample_num)


def roi_levels(boxes):
    """SingleRoIExtractor.map_roi_levels (v1): +1 areas, finest_scale 56."""
    scale = torch.sqrt((boxes[..., 2] - boxes[..., 0] + 1) *
                       (boxes[..., 3] - boxes[..., 1] + 1))
    lvl = torch.floor(torch.log2(true_div(scale, FINEST_SCALE) + 1e-6))
    return lvl.clamp(0, 3).to(torch.int64)


def flat_pyramid(pyramid: Sequence[torch.Tensor], lvl, per_image: int):
    """The levels (B, C, h, w) in one flat channels-last buffer (rows, C),
    and for each of B*per_image RoIs (image-major; `lvl` its level) the
    first row, height and width (float32) of its image's map on its
    level: one gather pass then serves all RoIs whatever their level."""
    B, dev = pyramid[0].shape[0], lvl.device
    flat = torch.cat([p.permute(0, 2, 3, 1).reshape(-1, p.shape[1]) for p in pyramid])
    hw = [(p.shape[2], p.shape[3]) for p in pyramid]
    starts = np.cumsum([0] + [B * h * w for h, w in hw])[:-1].tolist()
    t = lambda v, dt: _const(tuple(v), dt, dev)
    image = torch.arange(B, device=dev).repeat_interleave(per_image)
    base = t(starts, torch.int64)[lvl] + image * t([h * w for h, w in hw], torch.int64)[lvl]
    H = t([float(h) for h, _ in hw], torch.float32)[lvl]
    W = t([float(w) for _, w in hw], torch.float32)[lvl]
    return flat, base, H, W


def roi_align_pyramid(pyramid: Sequence[torch.Tensor], boxes) -> torch.Tensor:
    """Every RoI aligned on its own level (featmap_strides 4..32) only.
    pyramid: 4 maps (B, C, h, w); boxes (B, K, 4) -> (B*K, C, 7, 7)."""
    lvl = roi_levels(boxes).reshape(-1)
    flat, base, H, W = flat_pyramid(pyramid, lvl, boxes.shape[1])
    scale = _const(tuple(1.0 / s for s in ROI_STRIDES), torch.float32, boxes.device)[lvl]
    return _roi_align_flat(flat, base, H, W, scale, boxes.reshape(-1, 4), ROI_SIZE, 2)


# ---------------------------------------------------------------------------
# RPN proposals + cascade test-time path
# ---------------------------------------------------------------------------


def _mark(marks, name: str, dev) -> None:
    """Record a CUDA event named `name` on the current stream (marks is a
    list of (name, event), or None to record nothing)."""
    if marks is not None and dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))


def rpn_proposals(model: CascadeRCNN, pyramid, anchors_per_level, img_hw,
                  nms_pre: int, nms_post: int, max_num: int, nms_thr: float):
    """RPNHead.get_bboxes (v1) for a batch: per level sigmoid scores, the
    top nms_pre, the legacy decode and NMS keeping nms_post; then the top
    max_num over the levels. The levels' NMS run as one sweep. Returns
    (proposals (B, k, 4), valid (B, k))."""
    B = pyramid[0].shape[0]
    per = []
    for feat, anchors in zip(pyramid, anchors_per_level):
        cls, reg = model.rpn_head(feat)
        scores = torch.sigmoid(cls.permute(0, 2, 3, 1).reshape(B, -1))
        deltas = reg.permute(0, 2, 3, 1).reshape(B, -1, 4)
        k = min(nms_pre, scores.shape[1])
        top_s, top_i = stable_topk(scores, k)
        boxes = delta2bbox(anchors[top_i], deltas.gather(1, top_i[..., None].expand(B, k, 4)),
                           (1.0, 1.0, 1.0, 1.0), img_hw)
        per.append((boxes, top_s, min(nms_post, k)))
    # the levels padded to one length with -inf scores, swept together;
    # a level's first n picks are its own nms_pick(n)
    K = max(s.shape[1] for _, s, _ in per)
    boxes = torch.stack([F.pad(b, (0, 0, 0, K - b.shape[1])) for b, _, _ in per], 1)
    scores = torch.stack([F.pad(s, (0, K - s.shape[1]), value=-torch.inf)
                          for _, s, _ in per], 1)  # (B, L, K)
    idx, ok = nms_pick(boxes, scores, nms_thr, max(n for _, _, n in per))
    kept_b = boxes.gather(2, idx[..., None].expand(idx.shape + (4,)))
    kept_s = torch.where(ok, scores.gather(2, idx), -torch.inf)
    boxes_all = torch.cat([kept_b[:, i, :n] for i, (_, _, n) in enumerate(per)], 1)
    scores_all = torch.cat([kept_s[:, i, :n] for i, (_, _, n) in enumerate(per)], 1)
    top_s, top_i = stable_topk(scores_all, min(max_num, scores_all.shape[1]))
    proposals = boxes_all.gather(1, top_i[..., None].expand(top_i.shape + (4,)))
    return proposals, top_s > -torch.inf


def multiclass_nms(bboxes, scores, valid, score_thr: float, nms_thr: float,
                   max_per_img: int):
    """multiclass_nms (v1) for class-agnostic boxes: per foreground class a
    score threshold and greedy NMS keeping max_per_img, then the top
    max_per_img over the classes (ties: lower class, then pick order, as
    JAX's flat top_k). The classes share one IoU mask, gathered into each
    class's score order. bboxes (B, K, 4), scores (B, K, 81), valid (B, K)
    -> (boxes, scores, labels, ok), each (B, max_per_img[, 4])."""
    B, K = valid.shape
    cls = scores[..., 1:].transpose(1, 2)  # (B, 80, K)
    s = torch.where((cls > score_thr) & valid[:, None, :], cls, -torch.inf)
    s_sorted, order = torch.sort(s, dim=-1, descending=True, stable=True)
    over = iou_plus1(bboxes, bboxes) > nms_thr  # (B, K, K)
    frame = torch.arange(B, device=valid.device)[:, None, None, None]
    over_c = over[frame, order[..., :, None], order[..., None, :]]  # (B, 80, K, K)
    keep = greedy_keep(over_c, s_sorted > -torch.inf)
    pos, ok = _first_survivors(keep, max_per_img)
    pos = torch.where(ok, pos, 0)
    kept_s = torch.where(ok, s_sorted.gather(2, pos), -torch.inf)  # (B, 80, P)
    idx = torch.where(ok, order.gather(2, pos), 0)
    top_s, pick = stable_topk(kept_s.reshape(B, -1), max_per_img)
    det_idx = idx.reshape(B, -1).gather(1, pick)
    det_boxes = bboxes.gather(1, det_idx[..., None].expand(B, max_per_img, 4))
    labels = pick // idx.shape[2]
    return det_boxes, top_s, labels, top_s > -torch.inf


def cascade_stages(model: CascadeRCNN, pyramid, proposals, img_hw,
                   stages: Optional[dict] = None):
    """The cascade's three refinement stages on (B, K, 4) proposals: each
    RoIAligns the pyramid's first four levels at its rois, classifies and
    regresses; the final boxes come from the last stage's deltas, the
    scores from the softmax of the stages' mean logits. Returns (bboxes
    (B, K, 4), scores (B, K, 81)); `stages` collects each stage's rois,
    logits and deltas."""
    B, K = proposals.shape[:2]
    ms_logits = []
    rois = proposals
    for stage, head in enumerate(model.bbox_head):
        logits, reg = head(roi_align_pyramid(pyramid[:4], rois))
        logits, reg = logits.reshape(B, K, -1), reg.reshape(B, K, 4)
        if stages is not None:
            stages.setdefault("rois", []).append(rois)
            stages.setdefault("logits", []).append(logits)
            stages.setdefault("deltas", []).append(reg)
        ms_logits.append(logits)
        if stage < len(model.bbox_head) - 1:
            rois = delta2bbox(rois, reg, STAGE_STDS[stage], img_hw)
    n = len(ms_logits)
    bboxes = delta2bbox(rois, reg, STAGE_STDS[n - 1], img_hw)
    return bboxes, torch.softmax(true_div(sum(ms_logits), n), dim=-1)


def cascade_detect(model: CascadeRCNN, img, img_hw, anchors_per_level, *,
                   scale: float, nms_pre: int = 1000, nms_post: int = 1000,
                   max_num: int = 1000, rpn_nms_thr: float = 0.7,
                   score_thr: float = 0.05, rcnn_nms_thr: float = 0.5,
                   max_per_img: int = 100, stages: Optional[dict] = None,
                   marks: Optional[list] = None):
    """Full CascadeRCNN.simple_test on a batch of normalised images
    (B, 3, H, W). img_hw: the resized (pre-pad) shape boxes are clipped
    to; scale: the resize's factor, which the final boxes are divided by
    before the multiclass NMS. Returns (boxes (B, max_per_img, 4) in the
    original frame's coordinates, scores, labels, valid); labels are
    0-based COCO indices like the reference's result list positions.
    `stages`, when given, collects the intermediate tensors (pyramid,
    proposals, each stage's rois, logits and deltas, the final boxes and
    scores); `marks` CUDA events after each section (see _mark)."""
    dev = img.device
    with annotate("detect.backbone"):
        pyramid = model(img)
    _mark(marks, "backbone+fpn", dev)
    with annotate("detect.rpn"):
        proposals, valid = rpn_proposals(model, pyramid, anchors_per_level, img_hw,
                                         nms_pre, nms_post, max_num, rpn_nms_thr)
    _mark(marks, "rpn+nms", dev)
    with annotate("detect.stages"):
        bboxes, scores = cascade_stages(model, pyramid, proposals, img_hw, stages)
    _mark(marks, "stages", dev)
    with annotate("detect.nms"):
        out = multiclass_nms(true_div(bboxes, scale), scores, valid, score_thr,
                             rcnn_nms_thr, max_per_img)
    _mark(marks, "multiclass-nms", dev)
    if stages is not None:
        stages.update(pyramid=pyramid, proposals=proposals, valid=valid,
                      bboxes=bboxes, scores=scores)
    return out


# ---------------------------------------------------------------------------
# preprocessing: cv2's fixed-point INTER_LINEAR resize, on the card
# ---------------------------------------------------------------------------

IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)
RESIZE_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_BITS = 11


@functools.lru_cache(maxsize=16)
def _resize_taps(src: int, dst: int, clamp: bool):
    """cv2.resize's INTER_LINEAR taps along one axis (imgproc resize.cpp):
    the source coordinate in float32 from a float64 scale, floored, the
    fraction's two weights rounded to 11-bit fixed point with rint. The x
    axis clamps the border taps (weight 1 on the edge pixel); the y axis
    keeps the fraction and clamps the rows only."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        lo, hi = s < 0, s >= src - 1
        f[lo], s[lo] = 0, 0
        f[hi], s[hi] = 0, src - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(RESIZE_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(RESIZE_COEF_SCALE)).astype(np.int32)
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1)


@functools.lru_cache(maxsize=16)
def _device_taps(src: int, dst: int, clamp: bool, device: torch.device):
    """_resize_taps on `device`, uploaded once (see _const)."""
    return tuple(torch.from_numpy(a).to(device) for a in _resize_taps(src, dst, clamp))


def resize_linear_u8(frames, out_h: int, out_w: int):
    """cv2.resize(..., INTER_LINEAR) of a uint8 (B, H, W, C) tensor on its
    device, bit for bit: the horizontal pass in int32 (pixel x 11-bit
    weight), the vertical pass in cv2's SIMD form
    ((w0*(S0>>4))>>16 + (w1*(S1>>4))>>16 + 2) >> 2."""
    B, H, W, C = frames.shape
    dev = frames.device
    x0, x1, a0, a1 = _device_taps(W, out_w, True, dev)
    y0, y1, b0, b1 = _device_taps(H, out_h, False, dev)
    x = frames.to(torch.int32)
    rows = x[:, :, x0] * a0[:, None] + x[:, :, x1] * a1[:, None]  # (B, H, out_w, C)
    v = (((rows[:, y0] >> 4) * b0[:, None, None]) >> 16) + \
        (((rows[:, y1] >> 4) * b1[:, None, None]) >> 16)
    return ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)


def rescale_shape(h: int, w: int, long_edge: int = 1333,
                  short_edge: int = 800) -> Tuple[int, int, float]:
    """mmcv's keep-ratio rescale of an (h, w) image: (nh, nw, scale)."""
    scale = min(long_edge / max(h, w), short_edge / min(h, w))
    return int(h * scale + 0.5), int(w * scale + 0.5), scale


def preprocess(img_bgr: np.ndarray, long_edge: int = 1333,
               short_edge: int = 800) -> Tuple[np.ndarray, Tuple[int, int], float]:
    """Host form of the test pipeline's resize half
    (cascade_rcnn_r101_fpn_1x.py:175-189): keep-ratio rescale to (1333,
    800) on the uint8 image, BGR->RGB, pad to /32. Returns (padded uint8
    HWC RGB, resized (h, w), scale_factor), as the JAX package's. The
    detector runs the same resize on the card (`prepare_on_device`)."""
    nh, nw, scale = rescale_shape(*img_bgr.shape[:2], long_edge, short_edge)
    x = torch.from_numpy(np.ascontiguousarray(img_bgr))[None]
    resized = resize_linear_u8(x, nh, nw)[0].numpy()
    ph, pw = -(-nh // 32) * 32, -(-nw // 32) * 32
    out = np.zeros((ph, pw, 3), np.uint8)
    out[:nh, :nw] = resized[..., ::-1]
    return out, (nh, nw), scale


def normalize_on_device(img_u8, img_hw: Tuple[int, int]):
    """(x - mean) / std on a uint8 RGB canvas (..., H, W, 3), keeping the
    mmcv Pad semantic: the padding region (beyond img_hw) stays exactly
    0.0 because mmdet pads AFTER Normalize."""
    dev = img_u8.device
    x = (img_u8.to(torch.float32) - _const(tuple(IMG_MEAN.tolist()), torch.float32, dev)) / \
        _const(tuple(IMG_STD.tolist()), torch.float32, dev)
    H, W = img_u8.shape[-3:-1]
    inside = ((torch.arange(H, device=dev) < img_hw[0])[:, None]
              & (torch.arange(W, device=dev) < img_hw[1])[None, :])
    return torch.where(inside[..., None], x, 0.0)


def prepare_on_device(frames_bgr, long_edge: int = 1333, short_edge: int = 800):
    """A uint8 BGR stack (B, H, W, 3) on its device -> the network input
    (B, 3, PH, PW) normalised, the resized (h, w) and the scale factor:
    resize, BGR->RGB, pad to /32 with 0.0 after normalising."""
    B, h, w, _ = frames_bgr.shape
    nh, nw, scale = rescale_shape(h, w, long_edge, short_edge)
    ph, pw = -(-nh // 32) * 32, -(-nw // 32) * 32
    rgb = resize_linear_u8(frames_bgr, nh, nw).flip(-1)
    canvas = F.pad(rgb, (0, 0, 0, pw - nw, 0, ph - nh))
    x = normalize_on_device(canvas, (nh, nw))
    return x.permute(0, 3, 1, 2).contiguous(), (nh, nw), scale


# ---------------------------------------------------------------------------
# the inference_detector-equivalent wrapper
# ---------------------------------------------------------------------------


class CascadeDetect(nn.Module):
    """The detector's test-time forward as one module call: a uint8 BGR
    stack (B, H, W, 3) already on the model's device -> (boxes, scores,
    labels, ok), each (B, max_per_img[, 4]), boxes in the frames'
    coordinates. The keep-ratio resize, the normalisation and the pad
    (`detect.prep`), then cascade_detect. Gradients and TF32 are the
    caller's to turn off (MMDetCascadeDetector.forward_device does)."""

    def __init__(self, model: CascadeRCNN, img_scale: Tuple[int, int], test_cfg: dict):
        super().__init__()
        self.model = model
        self.img_scale = tuple(img_scale)
        self.test_cfg = dict(test_cfg)
        self._anchors: Dict[Tuple[int, int], List[torch.Tensor]] = {}

    def anchors(self, padded_hw: Tuple[int, int]) -> List[torch.Tensor]:
        padded_hw = tuple(padded_hw)
        if padded_hw not in self._anchors:
            dev = next(self.model.parameters()).device
            self._anchors[padded_hw] = [torch.from_numpy(grid_anchors(
                s, -(-padded_hw[0] // s), -(-padded_hw[1] // s))).to(dev)
                for s in ANCHOR_STRIDES]
        return self._anchors[padded_hw]

    def forward(self, frames_u8, stages: Optional[dict] = None,
                marks: Optional[list] = None):
        with annotate("detect.prep"):
            img, img_hw, scale = prepare_on_device(frames_u8, *self.img_scale)
        _mark(marks, "resize+upload", frames_u8.device)
        return cascade_detect(self.model, img, img_hw, self.anchors(img.shape[2:]),
                              scale=scale, stages=stages, marks=marks, **self.test_cfg)


def per_frame_detections(b, s, l, ok) -> list:
    """Host arrays of a batched detection (boxes (B, P, 4), scores,
    labels, ok) -> per frame (boxes, scores, labels) of its kept slots."""
    return [(b[i][ok[i]], s[i][ok[i]], l[i][ok[i]]) for i in range(len(b))]


class MMDetCascadeDetector:
    """AppearanceDetector backed by an mmdet cascade checkpoint, on
    `device` (the card unless the caller asks for the CPU), in full f32.

    detect(img) reproduces inference_detector(model, img) with
    rescale=True; __call__ adapts to the (boxes, scores) protocol that
    get_ap_bboxes-style filtering (fore.detector.filter_detections)
    consumes — class labels are dropped exactly like
    obj_det_with_motion.py:77-86 vstacks all classes. `net` is the
    forward as one module (CascadeDetect), which every route calls."""

    def __init__(self, model: CascadeRCNN, img_scale: Tuple[int, int] = (1333, 800),
                 device="cuda", **test_cfg):
        self.device = resolve_device(device)
        self.net = CascadeDetect(model.to(self.device).eval(), img_scale, test_cfg)

    @property
    def model(self) -> CascadeRCNN:
        return self.net.model

    @property
    def img_scale(self) -> Tuple[int, int]:
        return self.net.img_scale

    @classmethod
    def from_checkpoint(cls, path: str, depth: int | None = None, device="cuda",
                        **test_cfg):
        """depth=None infers it from the checkpoint's stage-3 block count
        (cascade_rcnn_r101_fpn_1x ships R101; R50/R152 variants load
        identically)."""
        resolve_device(device)
        ckpt = load_checkpoint_file(path)
        if depth is None:
            depth = infer_depth(strip_checkpoint(ckpt))
        model = load_mmdet_state(CascadeRCNN(depth), ckpt)
        return cls(model, device=device, **test_cfg)

    def scale(self, hw: Tuple[int, int]) -> float:
        """The keep-ratio scale factor of an (h, w) frame."""
        return rescale_shape(int(hw[0]), int(hw[1]), *self.img_scale)[2]

    def forward_device(self, frames_u8, stages: Optional[dict] = None,
                       marks: Optional[list] = None):
        """`net` on a uint8 BGR stack already on the device, without
        gradients and in full f32: (boxes, scores, labels, ok)."""
        with torch.no_grad(), full_f32():
            return self.net(frames_u8, stages=stages, marks=marks)

    def run(self, frames_bgr, stages: Optional[dict] = None,
            marks: Optional[list] = None):
        """One batched forward of a same-sized uint8 BGR stack (B, H, W, 3):
        -> (boxes, scores, labels, ok) tensors on the device, boxes in the
        frames' coordinates, and the scale factor."""
        _mark(marks, "start", self.device)
        x = torch.from_numpy(np.ascontiguousarray(frames_bgr)).to(self.device)
        return self.forward_device(x, stages, marks), self.scale(x.shape[1:3])

    def detect(self, img_bgr: np.ndarray):
        """-> (boxes (K, 4) in ORIGINAL image coords, scores (K,),
        labels (K,)) for kept detections."""
        return self.detect_many(np.asarray(img_bgr)[None])[0]

    def detect_many(self, frames_bgr, marks: Optional[list] = None) -> list:
        """Batched detect: one forward for a same-sized frame stack
        (precompute-boxes over a whole split is the caller, via
        compute_foreground_bboxes's detect_many path). Returns a list of
        (boxes, scores, labels) like detect() per frame."""
        (b, s, l, ok), _ = self.run(np.asarray(frames_bgr), marks=marks)
        return per_frame_detections(*(t.cpu().numpy() for t in (b, s, l, ok)))

    def __call__(self, img_bgr: np.ndarray):
        boxes, scores, _ = self.detect(img_bgr)
        return boxes, scores
