"""Cascade FPN detector: the reference's appearance-detector architecture
class, trainable (vec_vad_tpu/fore/cascade_detector.py).

The reference uses an mmdet Cascade R-CNN R101-FPN
(fore_det/obj_det_config/cascade_rcnn_r101_fpn_1x.py:1-160): a multi-scale
FPN feature pyramid plus iterative box refinement through R-CNN stages
with INCREASING IoU quality thresholds. What ships here is the same
architecture class, trainable from (frame, boxes) supervision:

  * conv backbone -> C2..C5 (strides 4/8/16/32),
  * FPN: 1x1 laterals + top-down upsampling + 3x3 smoothing -> P2..P5,
  * proposal stage: a shared anchor-free center head on every level
    (heatmap + size + offset), objects assigned to levels by scale,
  * cascade: 2 refinement stages; each RoIAligns a SxS feature patch from
    the scale-assigned level and regresses a standard R-CNN box delta +
    objectness, trained with rising IoU thresholds (0.5, 0.6) against its
    own stage inputs — the Cascade R-CNN recipe (config :75-146),
  * final score: mean of the cascade stages' calibrated scores.

NCHW throughout; convolutions pad as flax's 'SAME' (fore/centernet_
detector.same_conv), top-k keeps lax.top_k's tie order, and each RoI is
aligned on its own level only (JAX: on every level, one-hot selected).
The refine heads flatten RoI patches in torch's (C, S, S) order, so
models/convert.cascade_from_jax permutes the flax kernel's (S, S, C) rows.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vec_vad_torch.device import full_f32, resolve_device
from vec_vad_torch.fore.centernet_detector import (
    HEAT_BIAS,
    flax_init,
    nchw,
    same_conv,
)
from vec_vad_torch.fore.mmdet_detector import flat_pyramid, stable_topk, true_div

STRIDES = (4, 8, 16, 32)
# scale -> level assignment thresholds on sqrt(box area), in pixels
LEVEL_EDGES = (16.0, 32.0, 64.0)
ROI_SIZE = 5
STAGE_IOUS = (0.5, 0.6)  # rising cascade quality gates


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class FPNBackbone(nn.Module):
    """Conv backbone + FPN neck -> P2..P5, all `width*2` channels."""

    def __init__(self, width: int = 16):
        super().__init__()
        w = width
        stages = ((3, w), (w, w), (w, w * 2), (w * 2, w * 4), (w * 4, w * 4))
        self.blocks = nn.ModuleList([
            nn.Sequential(nn.Conv2d(cin, ch, 3, stride=2), nn.Conv2d(ch, ch, 3))
            for cin, ch in stages])
        fch = w * 2
        self.laterals = nn.ModuleList(
            [nn.Conv2d(ch, fch, 1) for _, ch in stages[1:]])
        self.smooth = nn.ModuleList([nn.Conv2d(fch, fch, 3) for _ in range(4)])

    def forward(self, x):
        cs = []
        for blk in self.blocks:  # /2, /4, /8, /16, /32
            x = F.relu(same_conv(blk[0], x))
            x = F.relu(same_conv(blk[1], x))
            cs.append(x)
        laterals = [lat(c) for lat, c in zip(self.laterals, cs[1:])]
        # top-down pathway (fpn neck)
        ps = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = ps[-1].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            ps.append(lat + up[:, :, : lat.shape[2], : lat.shape[3]])
        ps = ps[::-1]  # P2..P5
        return [F.relu(same_conv(conv, p)) for conv, p in zip(self.smooth, ps)]


class CenterHead(nn.Module):
    """Shared anchor-free proposal head (heat/size/offset), applied per
    level; sizes are regressed in units of the level's stride."""

    def __init__(self, in_ch: int = 32, width: int = 32):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, width, 3)
        self.heat = nn.Conv2d(width, 1, 3)
        self.size = nn.Conv2d(width, 2, 3)
        self.offset = nn.Conv2d(width, 2, 3)

    def forward(self, feat):
        h = F.relu(same_conv(self.conv, feat))
        return (same_conv(self.heat, h), same_conv(self.size, h),
                same_conv(self.offset, h))


class RefineHead(nn.Module):
    """One cascade stage: RoI feature patch (N, C, S, S) -> (box delta,
    objectness)."""

    def __init__(self, in_features: int, hidden: int = 64):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.delta = nn.Linear(hidden, 4)
        self.score = nn.Linear(hidden, 1)

    def forward(self, roi):
        x = roi.flatten(1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        # damped deltas stabilize early training
        return self.delta(x) * 0.1, self.score(x)[..., 0]


class CascadeFPNNet(nn.Module):
    def __init__(self, width: int = 16, head_width: int = 32):
        super().__init__()
        fch = width * 2
        self.backbone = FPNBackbone(width)
        self.head = CenterHead(fch, head_width)
        self.refine1 = RefineHead(fch * ROI_SIZE * ROI_SIZE)
        self.refine2 = RefineHead(fch * ROI_SIZE * ROI_SIZE)

    def pyramid(self, x):
        return self.backbone(x)

    def propose(self, pyramid):
        return [self.head(p) for p in pyramid]

    def refine(self, stage: int, roi):
        return (self.refine1 if stage == 0 else self.refine2)(roi)


def make_cascade_net(width: int = 16, seed: int = 0, device="cuda") -> CascadeFPNNet:
    """CascadeFPNNet with flax's default initialisation (heat bias -2.19)
    from a CPU torch.Generator seeded with `seed`, on `device`."""
    net = flax_init(CascadeFPNNet(width), torch.Generator().manual_seed(int(seed)))
    with torch.no_grad():
        net.head.heat.bias.fill_(HEAT_BIAS)
    return net.to(resolve_device(device))


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------


def _roi_align_flat(flat, base, H, W, stride, boxes, out: int):
    """mmdet RoIAlign with 1 sample per bin at its centre: N boxes, each
    from its own map in `flat` (per-box base row, size, stride) ->
    (N, C, out, out)."""
    b = boxes / stride[:, None]
    x0, y0, x1, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    bw = (x1 - x0).clamp_min(1e-3)
    bh = (y1 - y0).clamp_min(1e-3)
    i = true_div(torch.arange(out, dtype=torch.float32, device=boxes.device) + 0.5, out)
    xs = x0[:, None] + i[None, :] * bw[:, None] - 0.5  # (N, out)
    ys = y0[:, None] + i[None, :] * bh[:, None] - 0.5
    xf = torch.minimum(xs.clamp_min(0.0), W[:, None] - 1.0)
    yf = torch.minimum(ys.clamp_min(0.0), H[:, None] - 1.0)
    xl = torch.floor(xf).to(torch.int64)
    yt = torch.floor(yf).to(torch.int64)
    Wi, Hi = W.to(torch.int64)[:, None], H.to(torch.int64)[:, None]
    xr = torch.minimum(xl + 1, Wi - 1)
    yb = torch.minimum(yt + 1, Hi - 1)
    ax = (xf - xl)[:, None, :, None]  # (N, 1, out, 1)
    ay = (yf - yt)[:, :, None, None]  # (N, out, 1, 1)
    row0 = base[:, None, None]
    Wg = Wi[:, :, None]

    def gather(yy, xx):  # (N, out) x (N, out) -> (N, out, out, C)
        idx = row0 + yy[:, :, None] * Wg + xx[:, None, :]
        return flat[idx.reshape(-1)].reshape(idx.shape + (-1,))

    val = ((1 - ay) * (1 - ax) * gather(yt, xl)
           + (1 - ay) * ax * gather(yt, xr)
           + ay * (1 - ax) * gather(yb, xl)
           + ay * ax * gather(yb, xr))
    return val.permute(0, 3, 1, 2)


def roi_align(feat, boxes, stride, out: int = ROI_SIZE):
    """Sample an (out, out) patch per box with bilinear interpolation at bin
    centers — mmdet RoIAlign semantics (1 sample/bin). feat (C, H, W);
    boxes (N, 4) in IMAGE coords -> (N, C, out, out)."""
    C, H, W = feat.shape
    n, dev = boxes.shape[0], feat.device
    full = lambda v: torch.full((n,), float(v), dtype=torch.float32, device=dev)
    return _roi_align_flat(feat.permute(1, 2, 0).reshape(H * W, C),
                           torch.zeros(n, dtype=torch.int64, device=dev),
                           full(H), full(W), full(stride), boxes, out)


def level_of_boxes(boxes):
    """FPN scale assignment by sqrt(area) (the k = k0 + log2(scale/224)
    rule collapsed to static pixel edges)."""
    s = torch.sqrt((boxes[..., 2] - boxes[..., 0]).clamp_min(0.0)
                   * (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0))
    lvl = torch.zeros(s.shape, dtype=torch.int64, device=boxes.device)
    for e in LEVEL_EDGES:
        lvl = lvl + (s >= e).to(torch.int64)
    return lvl


def roi_align_pyramid(pyramid, boxes):
    """RoIAlign each box from its scale-assigned level only. pyramid: 4
    maps (B, C, h, w); boxes (B, K, 4) -> (B*K, C, S, S)."""
    lvl = level_of_boxes(boxes).reshape(-1)
    flat, base, H, W = flat_pyramid(pyramid, lvl, boxes.shape[1])
    stride = torch.tensor([float(s) for s in STRIDES], device=boxes.device)[lvl]
    return _roi_align_flat(flat, base, H, W, stride, boxes.reshape(-1, 4), ROI_SIZE)


def apply_delta(boxes, delta):
    """Standard R-CNN box transform: (dx, dy, dw, dh) on (cx, cy, w, h)."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-3)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-3)
    cx = boxes[..., 0] + w / 2 + delta[..., 0] * w
    cy = boxes[..., 1] + h / 2 + delta[..., 1] * h
    w = w * torch.exp(delta[..., 2].clamp(-2.0, 2.0))
    h = h * torch.exp(delta[..., 3].clamp(-2.0, 2.0))
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def encode_delta(src, dst):
    """Inverse of apply_delta: the regression target from src to dst."""
    sw = (src[..., 2] - src[..., 0]).clamp_min(1e-3)
    sh = (src[..., 3] - src[..., 1]).clamp_min(1e-3)
    dw = (dst[..., 2] - dst[..., 0]).clamp_min(1e-3)
    dh = (dst[..., 3] - dst[..., 1]).clamp_min(1e-3)
    return torch.stack([
        ((dst[..., 0] + dw / 2) - (src[..., 0] + sw / 2)) / sw,
        ((dst[..., 1] + dh / 2) - (src[..., 1] + sh / 2)) / sh,
        torch.log(dw / sw),
        torch.log(dh / sh),
    ], dim=-1)


def iou_matrix(a, b):
    """(..., N, 4) x (..., G, 4) -> (..., N, G) IoU."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])).clamp_min(0.0)
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])).clamp_min(0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-6)


def _clip_boxes(boxes, hw):
    H, W = hw
    return torch.stack([boxes[..., 0].clamp(0.0, W), boxes[..., 1].clamp(0.0, H),
                        boxes[..., 2].clamp(0.0, W), boxes[..., 3].clamp(0.0, H)], -1)


# ---------------------------------------------------------------------------
# Proposal decoding
# ---------------------------------------------------------------------------


def decode_proposals(level_outs, hw, k_per_level=16, top_k=32):
    """Multi-level center decode of a batch -> (B, top_k, 4) boxes +
    scores. level_outs: per level (heat, size, offset), NCHW."""
    cand_boxes, cand_scores = [], []
    for (heat, size, off), stride in zip(level_outs, STRIDES):
        p = torch.sigmoid(heat)[:, 0]
        pooled = F.max_pool2d(p[:, None], 3, stride=1, padding=1)[:, 0]
        p = torch.where(p >= pooled, p, 0.0)
        B, fh, fw = p.shape
        k = min(k_per_level, fh * fw)
        scores, idx = stable_topk(p.reshape(B, -1), k)
        iy = (idx // fw).to(torch.float32)
        ix = (idx % fw).to(torch.float32)
        take = lambda t: t.permute(0, 2, 3, 1).reshape(B, fh * fw, 2).gather(
            1, idx[..., None].expand(B, k, 2))
        sz, of = take(size), take(off)
        cx = (ix + of[..., 0]) * stride
        cy = (iy + of[..., 1]) * stride
        bw = sz[..., 0].clamp_min(0.0) * stride
        bh = sz[..., 1].clamp_min(0.0) * stride
        cand_boxes.append(_clip_boxes(torch.stack(
            [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1), hw))
        cand_scores.append(scores)
    boxes = torch.cat(cand_boxes, 1)
    scores = torch.cat(cand_scores, 1)
    top, idx = stable_topk(scores, top_k)
    return boxes.gather(1, idx[..., None].expand(idx.shape + (4,))), top


# ---------------------------------------------------------------------------
# Targets + losses
# ---------------------------------------------------------------------------


def make_level_targets(boxes_list: List[np.ndarray], hw: Tuple[int, int]):
    """Per-level gaussian heat + size/offset targets (host-side)."""
    H, W = hw
    out = []
    for stride in STRIDES:
        fh, fw = H // stride, W // stride
        n = len(boxes_list)
        heat = np.zeros((n, fh, fw, 1), np.float32)
        size = np.zeros((n, fh, fw, 2), np.float32)
        off = np.zeros((n, fh, fw, 2), np.float32)
        mask = np.zeros((n, fh, fw, 1), np.float32)
        out.append([heat, size, off, mask])
    ys_xs = [
        np.mgrid[0 : H // s, 0 : W // s] for s in STRIDES
    ]
    for i, boxes in enumerate(boxes_list):
        for b in np.asarray(boxes).reshape(-1, 4):
            side = np.sqrt(
                max(b[2] - b[0], 0.0) * max(b[3] - b[1], 0.0)
            )
            lvl = int(np.searchsorted(np.asarray(LEVEL_EDGES), side, "right"))
            s = STRIDES[lvl]
            heat, size, off, mask = out[lvl]
            fh, fw = heat.shape[1:3]
            cx, cy = (b[0] + b[2]) / 2 / s, (b[1] + b[3]) / 2 / s
            bw, bh = (b[2] - b[0]) / s, (b[3] - b[1]) / s
            ix = int(np.clip(cx, 0, fw - 1))
            iy = int(np.clip(cy, 0, fh - 1))
            sigma = max((bw + bh) / 12.0, 0.7)
            ys, xs = ys_xs[lvl]
            g = np.exp(
                -((xs - ix) ** 2 + (ys - iy) ** 2) / (2 * sigma**2)
            )
            heat[i, :, :, 0] = np.maximum(heat[i, :, :, 0], g)
            size[i, iy, ix] = (bw, bh)
            off[i, iy, ix] = (cx - ix, cy - iy)
            mask[i, iy, ix, 0] = 1.0
    return [tuple(t) for t in out]


def _center_loss(pred, targets):
    heat_p, size_p, off_p = pred
    heat_t, size_t, off_t, mask = targets
    p = torch.sigmoid(heat_p)
    pos = (heat_t >= 0.999).float()
    eps = 1e-6
    pos_loss = -pos * ((1 - p) ** 2) * torch.log(p + eps)
    neg_loss = -(1 - pos) * ((1 - heat_t) ** 4) * (p**2) * torch.log(1 - p + eps)
    n_pos = pos.sum().clamp_min(1.0)
    return (
        (pos_loss.sum() + neg_loss.sum()) / n_pos
        + 0.1 * (torch.abs(size_p - size_t) * mask).sum() / n_pos
        + (torch.abs(off_p - off_t) * mask).sum() / n_pos
    )


def _stage_loss(delta, score, boxes_in, gt, gt_valid, iou_thr):
    """One cascade stage's loss for each image of a batch (B,): L1 on
    encoded deltas for foreground proposals (IoU > 0.4 with best GT), BCE
    objectness labeled by the stage's rising IoU gate (Cascade R-CNN,
    config :75-146)."""
    iou = iou_matrix(boxes_in, gt)  # (B, K, G)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_iou, best = iou.max(dim=-1)
    matched_gt = gt.gather(1, best[..., None].expand(best.shape + (4,)))
    tgt = encode_delta(boxes_in, matched_gt)
    fg = (best_iou > 0.4).float()
    l_reg = (torch.abs(delta - tgt) * fg[..., None]).sum((1, 2)) / \
        (fg.sum(1) * 4).clamp_min(1.0)
    label = (best_iou > iou_thr).float()
    l_cls = F.binary_cross_entropy_with_logits(score, label, reduction="none").mean(1)
    return l_reg + l_cls


def cascade_loss(net: CascadeFPNNet, x, level_targets, gt, gt_valid, top_k: int):
    """The training objective of a batch: the center losses of every level
    plus the mean over images of both stages' losses. x (B, 3, H, W) in
    [0, 1]; level_targets per level (heat, size, offset, mask) NCHW."""
    H, W = x.shape[2:]
    pyr = net.pyramid(x)
    level_outs = net.propose(pyr)
    loss = 0.0
    for outs, tgt in zip(level_outs, level_targets):
        loss = loss + _center_loss(outs, tgt)
    with torch.no_grad():
        b, _ = decode_proposals(level_outs, (H, W), top_k=top_k)
    l_stage = 0.0
    for stage, thr in enumerate(STAGE_IOUS):
        delta, score = net.refine(stage, roi_align_pyramid(pyr, b))
        delta, score = delta.reshape(b.shape), score.reshape(b.shape[:2])
        l_stage = l_stage + _stage_loss(delta, score, b, gt, gt_valid, thr)
        b = apply_delta(b, delta).detach()
    return loss + l_stage.mean()


# ---------------------------------------------------------------------------
# Training + inference drivers
# ---------------------------------------------------------------------------


def detect_batch_cascade(net: CascadeFPNNet, frames, top_k: int):
    """frames (B, H, W, 3) uint8 tensor -> (boxes (B, top_k, 4), scores)."""
    x = true_div(frames.to(torch.float32), 255.0).permute(0, 3, 1, 2)
    H, W = x.shape[2:]
    pyr = net.pyramid(x)
    boxes, scores0 = decode_proposals(net.propose(pyr), (H, W), top_k=top_k)
    stage_scores = [scores0]
    for stage in range(2):
        delta, score = net.refine(stage, roi_align_pyramid(pyr, boxes))
        boxes = _clip_boxes(apply_delta(boxes, delta.reshape(boxes.shape)), (H, W))
        stage_scores.append(torch.sigmoid(score.reshape(scores0.shape)))
    # mmdet averages the cascade stages' classifiers at test time
    final = true_div(stage_scores[0] + stage_scores[1] + stage_scores[2], 3.0)
    return boxes, final


class CascadeDetector:
    """AppearanceDetector-protocol wrapper, on the net's device."""

    def __init__(self, net: CascadeFPNNet, top_k: int = 32):
        self.net = net.eval()
        self.top_k = top_k
        self.device = next(net.parameters()).device

    def __call__(self, img: np.ndarray):
        boxes, scores = self.detect_batch(img[None])
        return boxes[0], scores[0]

    def detect_batch(self, frames: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        with torch.no_grad(), full_f32():
            boxes, scores = detect_batch_cascade(self.net, x, self.top_k)
        return boxes.cpu().numpy(), scores.cpu().numpy()


def train_cascade_detector(
    frames: np.ndarray,
    boxes_list: List[np.ndarray],
    width: int = 16,
    steps: int = 300,
    batch_size: int = 8,
    learning_rate: float = 1e-3,
    top_k: int = 32,
    max_gt: int = 8,
    seed: int = 0,
    device="cuda",
    init_state=None,
) -> CascadeDetector:
    """Fit the cascade detector on (frame, boxes) supervision with Adam
    (optax's defaults), batches drawn by numpy default_rng(seed) as in the
    JAX package. init_state: a state dict to start from (else flax's init
    from `seed`)."""
    dev = resolve_device(device)
    H, W = frames.shape[1:3]
    net = make_cascade_net(width, seed, dev)
    if init_state is not None:
        net.load_state_dict(init_state)
    level_targets = [[nchw(t, dev) for t in tgt]
                     for tgt in make_level_targets(boxes_list, (H, W))]

    n = len(boxes_list)
    gt = np.zeros((n, max_gt, 4), np.float32)
    gt_valid = np.zeros((n, max_gt), bool)
    for i, bs in enumerate(boxes_list):
        bs = np.asarray(bs).reshape(-1, 4)[:max_gt]
        gt[i, : len(bs)] = bs
        gt_valid[i, : len(bs)] = True
    gt, gt_valid = torch.from_numpy(gt).to(dev), torch.from_numpy(gt_valid).to(dev)

    opt = torch.optim.Adam(net.parameters(), lr=learning_rate, eps=1e-8)
    rng = np.random.default_rng(seed)
    x_all = frames.astype(np.float32) / 255.0
    with full_f32():
        for _ in range(steps):
            sel = rng.integers(0, n, batch_size)
            sel_t = torch.from_numpy(sel).to(dev)
            tb = [[t[sel_t] for t in tgt] for tgt in level_targets]
            loss = cascade_loss(net, nchw(x_all[sel], dev), tb, gt[sel_t],
                                gt_valid[sel_t], top_k)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return CascadeDetector(net, top_k=top_k)
