"""Trainable CenterNet-lite appearance detector (vec_vad_tpu/fore/
jax_detector.py, whose `JaxDetector` is `CenterNetDetector` here).

A compact center-point detector (center heatmap + size + offset heads on
a strided conv backbone) that plugs into the AppearanceDetector protocol
(fore/detector.py) and the standard get_ap_bboxes filtering, trains from
scratch on (frame, boxes) supervision, and decodes a batch at once
(3x3 local-max NMS + top-k). It is a detector slot-filler, not a Cascade
R-CNN reproduction (that is fore/mmdet_detector.py).

Parity with the flax module: convolutions pad as flax's 'SAME' (at
stride 2 on an even input, 0 before and 1 after; `same_conv`), the
transposed convolution is flax's ConvTranspose (no kernel flip) as
torch's conv_transpose2d with the kernel flipped and padding 1
(models/convert.centernet_from_jax flips it), and the top-k keeps
lax.top_k's tie order (lower index first), which matters here: every
non-peak is an exact zero after the local max.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vec_vad_torch.device import full_f32, resolve_device
from vec_vad_torch.fore.mmdet_detector import stable_topk, true_div

STRIDE = 4
HEAT_BIAS = -2.19


def same_conv(conv: nn.Conv2d, x):
    """conv (built with padding 0) under flax's 'SAME' padding: total
    max((ceil(n/s) - 1)*s + k - n, 0) a dimension, the odd one after."""
    pads = []
    for n, k, s in ((x.shape[-1], conv.kernel_size[1], conv.stride[1]),
                    (x.shape[-2], conv.kernel_size[0], conv.stride[0])):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return conv(F.pad(x, pads))


def flax_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisation, drawn from `generator`: lecun_normal
    kernels (a normal truncated at two standard deviations, scaled to
    variance 1/fan_in) and zero biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                if isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw)
                    fan_in = w.shape[0] * w.shape[2] * w.shape[3]
                else:
                    fan_in = w[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return module


def _conv(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride)


class CenterNetLite(nn.Module):
    """Small center-point detector. Output stride 4."""

    def __init__(self, width: int = 32):
        super().__init__()
        w = width
        self.conv1 = _conv(3, w, 2)
        self.conv2 = _conv(w, w * 2, 2)
        self.conv3 = _conv(w * 2, w * 2)
        self.conv4 = _conv(w * 2, w * 4, 2)
        self.up = nn.ConvTranspose2d(w * 4, w * 2, 4, stride=2, padding=1)
        self.feat = _conv(w * 2, w * 2)
        self.heat = _conv(w * 2, 1)
        self.size = _conv(w * 2, 2)
        self.offset = _conv(w * 2, 2)

    def forward(self, x):
        """x: (B, 3, H, W) float in [0, 1] -> (heat (B, 1, H/4, W/4),
        size (B, 2, H/4, W/4), offset (B, 2, H/4, W/4))."""
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = F.relu(same_conv(conv, x))
        x = F.relu(self.up(x))
        feat = F.relu(same_conv(self.feat, x))
        return (same_conv(self.heat, feat), same_conv(self.size, feat),
                same_conv(self.offset, feat))


def make_centernet(width: int = 32, seed: int = 0, device="cuda") -> CenterNetLite:
    """CenterNetLite with flax's default initialisation (heat bias -2.19)
    from a CPU torch.Generator seeded with `seed`, on `device`."""
    net = flax_init(CenterNetLite(width), torch.Generator().manual_seed(int(seed)))
    with torch.no_grad():
        net.heat.bias.fill_(HEAT_BIAS)
    return net.to(resolve_device(device))


def make_targets(
    boxes_list: List[np.ndarray], hw: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Gaussian center heatmap + size/offset regression targets."""
    H, W = hw
    fh, fw = H // STRIDE, W // STRIDE
    n = len(boxes_list)
    heat = np.zeros((n, fh, fw, 1), np.float32)
    size = np.zeros((n, fh, fw, 2), np.float32)
    off = np.zeros((n, fh, fw, 2), np.float32)
    mask = np.zeros((n, fh, fw, 1), np.float32)
    ys, xs = np.mgrid[0:fh, 0:fw]
    for i, boxes in enumerate(boxes_list):
        for b in np.asarray(boxes).reshape(-1, 4):
            cx, cy = (b[0] + b[2]) / 2 / STRIDE, (b[1] + b[3]) / 2 / STRIDE
            bw, bh = (b[2] - b[0]) / STRIDE, (b[3] - b[1]) / STRIDE
            ix, iy = int(np.clip(cx, 0, fw - 1)), int(np.clip(cy, 0, fh - 1))
            sigma = max((bw + bh) / 12.0, 0.7)
            g = np.exp(-((xs - ix) ** 2 + (ys - iy) ** 2) / (2 * sigma ** 2))
            heat[i, :, :, 0] = np.maximum(heat[i, :, :, 0], g)
            size[i, iy, ix] = (bw, bh)
            off[i, iy, ix] = (cx - ix, cy - iy)
            mask[i, iy, ix, 0] = 1.0
    return heat, size, off, mask


def nchw(a, device) -> torch.Tensor:
    """An NHWC numpy array as an NCHW float32 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device).permute(0, 3, 1, 2)


def detection_loss(pred, targets):
    """Penalty-reduced focal loss on centers + masked L1 on size/offset.
    pred and targets NCHW."""
    heat_p, size_p, off_p = pred
    heat_t, size_t, off_t, mask = targets
    p = torch.sigmoid(heat_p)
    pos = (heat_t >= 0.999).float()
    eps = 1e-6
    pos_loss = -pos * ((1 - p) ** 2) * torch.log(p + eps)
    neg_loss = -(1 - pos) * ((1 - heat_t) ** 4) * (p ** 2) * torch.log(1 - p + eps)
    n_pos = pos.sum().clamp_min(1.0)
    l_heat = (pos_loss.sum() + neg_loss.sum()) / n_pos
    l_size = (torch.abs(size_p - size_t) * mask).sum() / n_pos
    l_off = (torch.abs(off_p - off_t) * mask).sum() / n_pos
    return l_heat + 0.1 * l_size + l_off


def detect_batch(net: CenterNetLite, frames, top_k: int):
    """frames: (B, H, W, 3) uint8 tensor -> (boxes (B, top_k, 4), scores)."""
    x = true_div(frames.to(torch.float32), 255.0).permute(0, 3, 1, 2)
    heat, size, off = net(x)
    p = torch.sigmoid(heat)[:, 0]  # (B, fh, fw)
    # 3x3 local-max NMS (the CenterNet trick)
    pooled = F.max_pool2d(p[:, None], 3, stride=1, padding=1)[:, 0]
    p = torch.where(p >= pooled, p, 0.0)
    B, fh, fw = p.shape
    scores, idx = stable_topk(p.reshape(B, -1), top_k)
    iy = (idx // fw).to(torch.float32)
    ix = (idx % fw).to(torch.float32)
    take = lambda t: t.permute(0, 2, 3, 1).reshape(B, fh * fw, 2).gather(
        1, idx[..., None].expand(B, top_k, 2))
    sz, of = take(size), take(off)
    cx = (ix + of[..., 0]) * STRIDE
    cy = (iy + of[..., 1]) * STRIDE
    bw = sz[..., 0].clamp_min(0.0) * STRIDE
    bh = sz[..., 1].clamp_min(0.0) * STRIDE
    H, W = frames.shape[1:3]
    # clip to the frame like mmdet does — downstream crop-resize assumes
    # in-frame boxes (the reference's numpy crop clamps implicitly)
    boxes = torch.stack([(cx - bw / 2).clamp(0.0, W), (cy - bh / 2).clamp(0.0, H),
                         (cx + bw / 2).clamp(0.0, W), (cy + bh / 2).clamp(0.0, H)], -1)
    return boxes, scores


class CenterNetDetector:
    """AppearanceDetector-protocol wrapper around CenterNetLite (the JAX
    package's `JaxDetector`), on the net's device."""

    def __init__(self, net: CenterNetLite, top_k: int = 32):
        self.net = net.eval()
        self.top_k = top_k
        self.device = next(net.parameters()).device

    def __call__(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        boxes, scores = self.detect_batch(img[None])
        return boxes[0], scores[0]

    def detect_batch(self, frames: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        with torch.no_grad(), full_f32():
            boxes, scores = detect_batch(self.net, x, self.top_k)
        return boxes.cpu().numpy(), scores.cpu().numpy()


def train_detector(
    frames: np.ndarray,
    boxes_list: List[np.ndarray],
    width: int = 16,
    steps: int = 200,
    batch_size: int = 8,
    learning_rate: float = 1e-3,
    seed: int = 0,
    device="cuda",
    init_state=None,
) -> CenterNetDetector:
    """Fit CenterNetLite on (frame, boxes) supervision with Adam (optax's
    defaults), batches drawn by numpy default_rng(seed) as in the JAX
    package. init_state: a state dict to start from (else flax's init
    from `seed`)."""
    dev = resolve_device(device)
    H, W = frames.shape[1:3]
    net = make_centernet(width, seed, dev)
    if init_state is not None:
        net.load_state_dict(init_state)
    targets = [nchw(t, dev) for t in make_targets(boxes_list, (H, W))]
    opt = torch.optim.Adam(net.parameters(), lr=learning_rate, eps=1e-8)
    rng = np.random.default_rng(seed)
    n = frames.shape[0]
    x_all = frames.astype(np.float32) / 255.0
    with full_f32():
        for _ in range(steps):
            sel = rng.integers(0, n, batch_size)
            xb = nchw(x_all[sel], dev)
            sel_t = torch.from_numpy(sel).to(dev)
            loss = detection_loss(net(xb), [t[sel_t] for t in targets])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return CenterNetDetector(net)
