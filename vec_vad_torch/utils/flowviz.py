"""Flow visualization and IO, a port of vec_vad_tpu/utils/flowviz.py
(capability parity with flowlib.py).

Middlebury color-wheel rendering (flowlib.py:244-282,431-522), .flo file
IO (flowlib.py:84-121), KITTI-style 16-bit png IO over the port's PNG
codec (`utils/png.py`, the files cv2 would read and write), flow error
metrics (flowlib.py:189-242), and a backward warp of a host image through
the port's `models/flownet/ops.warp_bilinear` on a device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

UNKNOWN_FLOW_THRESH = 1e7
SMALL_FLOW = 0.0
LARGE_FLOW = 1e8
TAG_FLOAT = 202021.25


# ---------------------------------------------------------------------------
# Color wheel
# ---------------------------------------------------------------------------


def make_color_wheel() -> np.ndarray:
    """(55, 3) RGB Middlebury color wheel: RY15 YG6 GC4 CB11 BM13 MR6."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = []
    for n, (c0, c1, up) in zip(
        (ry, yg, gc, cb, bm, mr),
        [
            ((255, 0, 0), "g", True),
            ((255, 255, 0), "r", False),
            ((0, 255, 0), "b", True),
            ((0, 255, 255), "g", False),
            ((0, 0, 255), "r", True),
            ((255, 0, 255), "b", False),
        ],
    ):
        base, chan, increasing = c0, c1, up
        for i in range(n):
            c = np.array(base, dtype=np.float64)
            v = np.floor(255.0 * i / n)
            idx = {"r": 0, "g": 1, "b": 2}[chan]
            c[idx] = v if increasing else 255 - v
            wheel.append(c)
    return np.array(wheel)


_WHEEL = make_color_wheel()


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Map normalized flow components to RGB via the color wheel."""
    h, w = u.shape
    img = np.zeros((h, w, 3), dtype=np.uint8)
    nan = np.isnan(u) | np.isnan(v)
    u = np.where(nan, 0, u)
    v = np.where(nan, 0, v)

    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi  # (-1, 1]
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        inside = rad <= 1
        col = np.where(inside, 1 - rad * (1 - col), col * 0.75)
        img[:, :, c] = np.where(nan, 0, np.floor(255.0 * col)).astype(np.uint8)
    return img


def flow_to_image(flow: np.ndarray, max_flow: Optional[float] = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 RGB (flowlib.py:244-282)."""
    u = flow[:, :, 0].astype(np.float64).copy()
    v = flow[:, :, 1].astype(np.float64).copy()
    bad = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[bad] = 0
    v[bad] = 0
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max_flow if max_flow is not None else max(float(rad.max()), -1.0)
    eps = np.finfo(float).eps
    img = compute_color(u / (maxrad + eps), v / (maxrad + eps))
    img[bad] = 0
    return img


# ---------------------------------------------------------------------------
# IO
# ---------------------------------------------------------------------------


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)[0]
        if magic != np.float32(TAG_FLOAT):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"a .flo holds (H, W, 2) flow, got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([TAG_FLOAT], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_kitti_png(path: str) -> np.ndarray:
    """KITTI 16-bit png: (flow*64 + 2^15, valid) encoding -> (H, W, 3)
    [u, v, valid] (flowlib.py:126-150)."""
    from vec_vad_torch.utils.png import read_png

    raw = read_png(path).astype(np.float64)
    # read BGR, as cv2 does -> channels reversed vs (u, v, valid) rgb encoding
    raw = raw[:, :, ::-1]
    flow = np.zeros_like(raw)
    flow[:, :, :2] = (raw[:, :, :2] - 2 ** 15) / 64.0
    flow[:, :, 2] = raw[:, :, 2]
    flow[raw[:, :, 2] == 0, :2] = 0
    return flow


def write_kitti_png(path: str, flow: np.ndarray) -> None:
    from vec_vad_torch.utils.png import write_png

    h, w = flow.shape[:2]
    out = np.zeros((h, w, 3), np.uint16)
    out[:, :, 0] = np.clip(flow[:, :, 0] * 64.0 + 2 ** 15, 0, 65535).astype(np.uint16)
    out[:, :, 1] = np.clip(flow[:, :, 1] * 64.0 + 2 ** 15, 0, 65535).astype(np.uint16)
    out[:, :, 2] = 1
    write_png(path, out[:, :, ::-1])


def read_disp_png(path: str) -> np.ndarray:
    """KITTI 16-bit disparity png -> (H, W) float disparity in pixels
    (flowlib.py:316-331: first png channel / 256)."""
    from vec_vad_torch.utils.png import read_png

    raw = read_png(path)
    if raw.ndim == 3:
        # color pngs read BGR, as cv2 does; the png-library reference reads
        # channel 0 in file (RGB) order, i.e. the last channel here.
        raw = raw[:, :, ::-1][:, :, 0]
    return raw.astype(np.float64) / 256.0


def disp_to_flowfile(disp: np.ndarray, path: str) -> None:
    """Pack a (H, W) disparity map as a .flo whose v-channel is zero
    (flowlib.py:334-352)."""
    flow = np.dstack([disp.astype(np.float32), np.zeros_like(disp, np.float32)])
    write_flo(path, flow)


# ---------------------------------------------------------------------------
# Segmentation / display helpers
# ---------------------------------------------------------------------------


def segment_flow(flow: np.ndarray) -> np.ndarray:
    """Quantize flow directions into 8 octant classes (flowlib.py:150-184).

    Class 0 = zero flow or invalid (|component| > LARGE_FLOW); classes 1-8
    walk the octants counter-clockwise from the +u half of the first
    quadrant. Matches the reference's predicate set exactly, including the
    u==0 -> 1e-5 substitution before the tangent.
    """
    u = flow[:, :, 0].astype(np.float64).copy()
    v = flow[:, :, 1].astype(np.float64).copy()
    invalid = (np.abs(u) > LARGE_FLOW) | (np.abs(v) > LARGE_FLOW)
    zero = (u == 0) & (v == 0)
    u = np.where(np.abs(u) == SMALL_FLOW, 1e-5, u)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = v / u

    seg = np.zeros(u.shape, dtype=np.float64)
    octants = [
        (1, (t < 1) & (t >= 0) & (u > 0) & (v >= 0)),
        (2, (t >= 1) & (u >= 0) & (v >= 0)),
        (3, (t < -1) & (u <= 0) & (v >= 0)),
        (4, (t < 0) & (t >= -1) & (u < 0) & (v >= 0)),
        (5, (t >= 0) & (t < 1) & (u < 0) & (v <= 0)),
        (6, (t >= 1) & (u <= 0) & (v <= 0)),
        (7, (t < -1) & (u >= 0) & (v <= 0)),
        (8, (t >= -1) & (t < 0) & (u > 0) & (v <= 0)),
    ]
    # The reference assigns class1..class8 sequentially, so later classes win
    # where predicates overlap at octant boundaries — preserve that order.
    for label, mask in octants:
        seg[mask] = label
    seg[zero] = 0
    seg[invalid] = 0
    return seg


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Vectorized HSV->RGB on float arrays in [0, 1] (no matplotlib needed)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(int) % 6
    choices = [
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q),
    ]
    out = np.zeros(hsv.shape, dtype=np.float64)
    for k, (r, g, b) in enumerate(choices):
        m = i == k
        out[..., 0] = np.where(m, r, out[..., 0])
        out[..., 1] = np.where(m, g, out[..., 1])
        out[..., 2] = np.where(m, b, out[..., 2])
    return out


def render_flow(flow: np.ndarray, mode: str = "Y") -> np.ndarray:
    """Render a flow map to a display image (flowlib.py:40-82 semantics).

    mode 'Y': Middlebury color wheel (uint8 RGB). mode 'RGB': HSV
    angle/magnitude encoding of a 3-channel (u, v, valid) flow (float RGB
    in [0, 1], invalid pixels zeroed) — the reference's visualize_flow
    'RGB' branch.
    """
    if mode == "Y":
        return flow_to_image(flow)
    if mode != "RGB":
        raise ValueError(f"unknown flow render mode {mode!r}")
    du = flow[:, :, 0].astype(np.float64)
    dv = flow[:, :, 1].astype(np.float64)
    valid = (
        flow[:, :, 2].astype(np.float64)
        if flow.shape[2] > 2
        else np.ones_like(du)
    )
    max_flow = max(float(np.max(du)), float(np.max(dv)))
    img = np.zeros(du.shape + (3,), dtype=np.float64)
    img[:, :, 0] = np.arctan2(dv, du) / (2 * np.pi)
    img[:, :, 1] = np.sqrt(du * du + dv * dv) * 8 / max_flow
    img[:, :, 2] = 8 - img[:, :, 1]
    img = np.clip(img, 0.0, 1.0)
    img = _hsv_to_rgb(img)
    return img * valid[:, :, None]


def visualize_flow(flow: np.ndarray, mode: str = "Y", show: bool = True):
    """Render (and optionally plt.show) a flow map (flowlib.py:40-82)."""
    img = render_flow(flow, mode=mode)
    if show:  # pragma: no cover - needs a display
        import matplotlib.pyplot as plt

        plt.imshow(img)
        plt.show()
    return img


def show_flow(path: str, show: bool = True):
    """Read a .flo file and display it (flowlib.py:29-37)."""
    return visualize_flow(read_flo(path), mode="Y", show=show)


def scale_image(image: np.ndarray, new_range) -> np.ndarray:
    """Linearly rescale an image into new_range as uint8
    (flowlib.py:416-428)."""
    lo, hi = float(np.min(image)), float(np.max(image))
    new_lo, new_hi = float(min(new_range)), float(max(new_range))
    scaled = (image - lo) / (hi - lo) * (new_hi - new_lo) + new_lo
    return scaled.astype(np.uint8)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def flow_error(
    tu: np.ndarray, tv: np.ndarray, u: np.ndarray, v: np.ndarray
) -> float:
    """Mean endpoint error over known pixels (flowlib.py:189-242)."""
    known = (np.abs(tu) <= UNKNOWN_FLOW_THRESH) & (
        np.abs(tv) <= UNKNOWN_FLOW_THRESH
    )
    du = u[known] - tu[known]
    dv = v[known] - tv[known]
    return float(np.mean(np.sqrt(du ** 2 + dv ** 2)))


def warp_image_np(img: np.ndarray, flow: np.ndarray, device="cuda") -> np.ndarray:
    """Backward warp of a host (H, W, C) image by (H, W, 2) flow
    (flowlib.py:373-400 capability) through models.flownet.ops.
    warp_bilinear on `device` (the card unless the caller asks for the
    CPU); returns float32 (H, W, C)."""
    import torch

    from vec_vad_torch.device import resolve_device
    from vec_vad_torch.models.flownet.ops import warp_bilinear

    dev = resolve_device(device)
    out = warp_bilinear(
        torch.as_tensor(np.asarray(img, np.float32)[None], device=dev),
        torch.as_tensor(np.asarray(flow, np.float32)[None], device=dev),
    )
    return out[0].cpu().numpy()
