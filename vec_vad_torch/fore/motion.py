"""Motion-gradient foreground detector (vec_vad_tpu/fore/motion.py).

Parity with `get_mt_bboxes` (fore_det/obj_det_with_motion.py:144-223):
Gaussian-blur adjacent frames of a 3-frame window, accumulate absolute
differences, binary-threshold, zero out (extended) appearance-box regions,
find connected components, keep boxes by area/aspect, extend by 2 px.

The dense per-pixel part (blur, absdiff, threshold, channel reduction)
runs as torch ops on the windows' device, batched over frames. The blur
keeps the JAX package's arithmetic: each tap is a separate elementwise
float32 multiply-add in its order, not a convolution, whose own summation
order (or TF32) could flip a .5 rounding and so a map bit. With cv2's
small dyadic taps every product and partial sum is exact in float32, so
the maps equal the JAX package's bit for bit on any device.

The per-component part (bounding boxes of the external contours of a
sparse binary map) runs on the host without cv2: filling the holes (the
background's 4-connected components that touch no border, as
findContours sees the background) drops every component nested in
another's hole, as RETR_EXTERNAL does; 8-connected labels of the filled
map then give the external contours' bounding rectangles, and the
reversed label (raster) order is cv2.findContours' order. Both labelings
are one scipy.ndimage.label pass each (binary_fill_holes would iterate a
dilation as often as the frame is wide).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# cv2 getGaussianKernel's fixed coefficients for small kernels at sigma<=0.
_GAUSS_TAPS = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}
_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)
_SQUARE = np.ones((3, 3), bool)


def _blur_u8(x: torch.Tensor, k: int) -> torch.Tensor:
    """Separable Gaussian blur with BORDER_REFLECT_101 and uint8 rounding
    (half to even, as jnp.round), batched over leading dims.
    x: (..., H, W, C) uint8 -> uint8."""
    taps = torch.tensor(_GAUSS_TAPS[k], dtype=torch.float32, device=x.device)
    pad = k // 2
    H, W, C = x.shape[-3:]
    # (N, C, H, W): F.pad's "reflect" is reflect-101 (edge pixel not repeated)
    xp = x.reshape((-1, H, W, C)).permute(0, 3, 1, 2).float()
    xp = F.pad(xp, (0, 0, pad, pad), mode="reflect")
    y = taps[0] * xp[:, :, 0:H, :]
    for i in range(1, k):
        y = y + taps[i] * xp[:, :, i:i + H, :]
    yp = F.pad(y, (pad, pad, 0, 0), mode="reflect")
    y = taps[0] * yp[..., 0:W]
    for i in range(1, k):
        y = y + taps[i] * yp[..., i:i + W]
    out = torch.round(y).to(torch.uint8).permute(0, 2, 3, 1)
    return out.reshape(x.shape)


def _threshold_maps(blurred: torch.Tensor, binary_thr: int) -> torch.Tensor:
    """(B, 3, H, W, C) blurred uint8 windows -> (B, H, W) bool."""
    b = blurred.to(torch.int16)
    d01 = (b[:, 0] - b[:, 1]).abs().to(torch.uint8)
    d12 = (b[:, 1] - b[:, 2]).abs().to(torch.uint8)
    acc = d01 + d12  # uint8 wraparound, as in the reference's numpy sum
    return (acc > int(binary_thr)).any(dim=-1)


def motion_maps(windows, gauss_k: int, binary_thr: int) -> torch.Tensor:
    """Batched binary motion maps on the windows' device.

    windows: (B, 3, H, W, C) uint8 — each frame's hard-bordered 3-frame
    context (obj_det_with_motion.py:176-185). Returns (B, H, W) bool:
    True where ANY channel's accumulated gradient exceeds binary_thr."""
    windows = torch.as_tensor(windows)
    return _threshold_maps(_blur_u8(windows, int(gauss_k)), binary_thr)


def motion_bboxes(
    binary_map: np.ndarray,
    ap_boxes: Optional[np.ndarray],
    area_thr: float,
    extend: int,
) -> np.ndarray:
    """Host-side component stage for ONE frame's binary map.

    Zeroes (extended) appearance-box regions, finds external contours,
    keeps boxes with (w+1)*(h+1) > area_thr and aspect < 10, extends by
    `extend` px clamped to the frame (obj_det_with_motion.py:190-218).
    Returns (M, 4) int64 boxes, or a float64 (0, 4) when none is kept."""
    from scipy import ndimage

    m = np.array(binary_map, dtype=bool)
    h, w = m.shape
    if ap_boxes is not None:
        for b in np.asarray(ap_boxes).astype(np.int32):
            y1 = max(0, b[1] - extend)
            y2 = min(b[3] + extend, h)
            x1 = max(0, b[0] - extend)
            x2 = min(b[2] + extend, w)
            m[y1 : y2 + 1, x1 : x2 + 1] = False

    # holes: background components (4-connected) that touch no border
    bg, n_bg = ndimage.label(~m, structure=_CROSS)
    hole = np.ones(n_bg + 1, bool)
    hole[np.concatenate([bg[0], bg[-1], bg[:, 0], bg[:, -1]])] = False
    hole[0] = True  # the foreground itself
    labels, _ = ndimage.label(hole[bg], structure=_SQUARE)
    out: List[List[int]] = []
    for ys, xs in reversed(ndimage.find_objects(labels)):
        x, y = xs.start, ys.start
        cw, ch = xs.stop - xs.start, ys.stop - ys.start
        if (cw + 1) * (ch + 1) > area_thr and cw / ch < 10 and ch / cw < 10:
            out.append(
                [
                    max(0, x - extend),
                    max(0, y - extend),
                    min(x + cw + extend, w),
                    min(y + ch + extend, h),
                ]
            )
    return np.array(out) if out else np.zeros((0, 4))
