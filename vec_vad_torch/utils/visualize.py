"""Visualization helpers, a port of vec_vad_tpu/utils/visualize.py
(capability parity with helper/visualization_helper.py) without cv2.

Score masks to grayscale images, cube batches to tiled grids, and
prediction/target pairs with JET error heatmaps. The three cv2 calls of
the JAX package have stand-ins here, each held equal to cv2 by the tests:
`apply_jet` (cv2.applyColorMap(COLORMAP_JET)), `add_weighted`
(cv2.addWeighted on uint8) and `resize_nearest` (cv2.resize with
INTER_NEAREST).

Departure: `_to_u8` scales by 255 only float input in [0, 1.5]; the JAX
package's also scales uint8 frames whose maximum is 0 or 1, turning a
near-black frame white.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_JET): the
# (256, 3) BGR table, level by level
JET_BGR = np.frombuffer(bytes.fromhex(
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000"
    "b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000"
    "e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00"
    "ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00"
    "ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00"
    "ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00"
    "ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e"
    "ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e"
    "9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e"
    "6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee"
    "0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff"
    "00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff"
    "00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff"
    "004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff"
    "001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0"
    "0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090"
    "00008c000088000084000080"
), np.uint8).reshape(256, 3)


def apply_jet(gray: np.ndarray) -> np.ndarray:
    """uint8 (...) levels -> (..., 3) BGR colours of cv2's COLORMAP_JET."""
    return JET_BGR[np.asarray(gray, np.uint8)]


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray,
                 beta: float, gamma: float = 0.0) -> np.ndarray:
    """cv2.addWeighted on uint8 images: fma(src1, alpha, fma(src2, beta,
    gamma)) in float32, rounded half to even and saturated to uint8."""
    inner = (np.asarray(src2, np.float64) * np.float64(np.float32(beta))
             + np.float64(np.float32(gamma))).astype(np.float32)
    t = (np.asarray(src1, np.float64) * np.float64(np.float32(alpha))
         + inner.astype(np.float64)).astype(np.float32)
    return np.clip(np.rint(t), 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST): output pixel
    x reads source pixel min(floor(x * src / dst), src - 1) on each axis."""
    img = np.asarray(img)
    (dh, dw), (sh, sw) = hw, img.shape[:2]
    ys = np.minimum(np.floor(np.arange(dh) * (sh / dh)).astype(np.int64), sh - 1)
    xs = np.minimum(np.floor(np.arange(dw) * (sw / dw)).astype(np.int64), sw - 1)
    return img[ys][:, xs]


def visualize_score(score_mask: np.ndarray, big_number: float = 1e5) -> np.ndarray:
    """(H, W) score mask -> uint8 grayscale image, -big_number floor mapped
    to 0 (visualization_helper.py:6-19)."""
    m = np.asarray(score_mask, dtype=np.float64)
    m = np.where(m <= -big_number, np.nan, m)
    if np.isnan(m).all():  # no cube covered any pixel: render black
        return np.zeros(m.shape, np.uint8)
    lo = float(np.nanmin(m))
    hi = float(np.nanmax(m))
    rng = hi - lo if hi > lo else 1.0
    out = (m - lo) / rng * 255.0
    return np.nan_to_num(out, nan=0.0).astype(np.uint8)


def tile_batch(batch: np.ndarray, cols: int = 8) -> np.ndarray:
    """(N, H, W, C) -> one tiled (rows*H, cols*W, C) image."""
    n, h, w, c = batch.shape
    rows = -(-n // cols)
    canvas = np.zeros((rows * h, cols * w, c), dtype=batch.dtype)
    for i in range(n):
        r, cc = divmod(i, cols)
        canvas[r * h : (r + 1) * h, cc * w : (cc + 1) * w] = batch[i]
    return canvas


def _to_u8(img: np.ndarray) -> np.ndarray:
    """uint8 display image: float input in [0, 1.5] is scaled by 255, any
    other input clipped to [0, 255]."""
    img = np.asarray(img)
    scale = np.issubdtype(img.dtype, np.floating) and img.max() <= 1.5
    img = img.astype(np.float64)
    if scale:
        img = img * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def error_heatmap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """JET colormap of |a - b| summed over channels
    (visualization_helper.py:70-113)."""
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    if err.ndim == 3:
        err = err.sum(axis=-1)
    err = (err / (err.max() + 1e-9) * 255.0).astype(np.uint8)
    return apply_jet(err)


def visualize_pair_map(
    batch_1: np.ndarray, batch_2: np.ndarray, cols: int = 8
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(targets, outputs) cube batches -> (tiled targets, tiled outputs,
    tiled error heatmaps)."""
    t1 = tile_batch(_to_u8(batch_1), cols)
    t2 = tile_batch(_to_u8(batch_2), cols)
    heat = tile_batch(
        np.stack([error_heatmap(a, b) for a, b in zip(batch_1, batch_2)]), cols
    )
    return t1, t2, heat


def score_mask_overlay(
    frame: np.ndarray,
    score_mask: np.ndarray,
    big_number: float = 1e5,
    alpha: float = 0.5,
) -> np.ndarray:
    """Blend a JET heatmap of the anomaly-score mask onto the frame.

    Pixels at the -big_number floor (no cube covered them, test.py:350-357's
    mask init) keep the original frame; scored pixels get `alpha` of the
    colormapped score. Frame may be grayscale or BGR, any HxW: the mask is
    resized to match (nearest)."""
    frame = np.asarray(frame)
    if frame.ndim == 2:
        frame = np.repeat(frame[:, :, None], 3, axis=2)
    frame = _to_u8(frame)
    m = np.asarray(score_mask, dtype=np.float64)
    covered = m > -big_number
    heat = apply_jet(visualize_score(score_mask, big_number))
    if heat.shape[:2] != frame.shape[:2]:
        heat = resize_nearest(heat, frame.shape[:2])
        covered = resize_nearest(covered.astype(np.uint8), frame.shape[:2]) > 0
    out = frame.copy()
    blend = add_weighted(frame, 1.0 - alpha, heat, alpha, 0.0)
    out[covered] = blend[covered]
    return out
