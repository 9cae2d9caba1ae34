"""Synthetic micro-datasets for tests and benchmarks.

A copy of vec_vad_tpu/data/synthetic.py (NumPy only), so the port and
chip_smoke.py generate the same videos from the same seed without
importing the JAX package.

The environment ships no raw video data (only the reference's bbox fixture
files), so tests exercise the full pipeline on generated videos: gray
background + moving squares. "Normal" squares move slowly with a fixed
texture; anomalous test squares are brighter/faster, so a completion model
trained on normal data scores them high.

Layout written to disk matches UCSDped2 (Train/Train001..., Test/Test001...,
Test001_gt/*.bmp masks) so VideoIndex.from_layout and the GT readers consume
it unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class SyntheticDataset:
    root: str
    name: str
    frame_h: int
    frame_w: int
    train_frames: np.ndarray  # (N_train, H, W, 3) uint8
    test_frames: np.ndarray  # (N_test, H, W, 3) uint8
    test_labels: np.ndarray  # (N_test,) int
    train_boxes: List[np.ndarray]  # per frame (K_i, 4) xyxy
    test_boxes: List[np.ndarray]
    train_video_lengths: np.ndarray
    test_video_lengths: np.ndarray


def _render_square(frame: np.ndarray, x: float, y: float, size: int, color) -> None:
    h, w = frame.shape[:2]
    x0, y0 = int(round(x)), int(round(y))
    x1, y1 = min(x0 + size, w), min(y0 + size, h)
    x0, y0 = max(x0, 0), max(y0, 0)
    frame[y0:y1, x0:x1] = color


def _make_video(
    rng: np.random.Generator,
    n_frames: int,
    h: int,
    w: int,
    anomalous_frames: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, List[np.ndarray], np.ndarray]:
    frames = np.full((n_frames, h, w, 3), 90, dtype=np.uint8)
    # Textured static background so completion has structure to learn.
    bg = (90 + 30 * np.sin(np.arange(w) / 7.0)[None, :] + 20 * np.cos(np.arange(h) / 5.0)[:, None])
    frames[:] = np.clip(bg, 0, 255).astype(np.uint8)[None, :, :, None]

    size = max(8, h // 6)
    n_obj = 2
    xs = rng.uniform(0, w - size, n_obj)
    ys = rng.uniform(0, h - size, n_obj)
    # narrow speed band: keeps normal motion statistics consistent across
    # videos so the "normal" class is learnable from few videos
    vxs = rng.uniform(0.9, 1.3, n_obj) * rng.choice([-1, 1], n_obj)
    vys = rng.uniform(0.4, 0.7, n_obj) * rng.choice([-1, 1], n_obj)
    colors = [(170, 170, 170), (50, 50, 50)]

    boxes: List[np.ndarray] = []
    labels = np.zeros(n_frames, dtype=np.int64)
    for t in range(n_frames):
        frame_boxes = []
        for k in range(n_obj):
            # bounce off the frame edges (no teleporting wraps — a wrap
            # would be an unpredictable event the completion model rightly
            # flags, polluting the "normal" class)
            xs[k] += vxs[k]
            ys[k] += vys[k]
            if not (0 <= xs[k] <= w - size):
                vxs[k] = -vxs[k]
                xs[k] = np.clip(xs[k], 0, w - size)
            if not (0 <= ys[k] <= h - size):
                vys[k] = -vys[k]
                ys[k] = np.clip(ys[k], 0, h - size)
            _render_square(frames[t], xs[k], ys[k], size, colors[k])
            frame_boxes.append([xs[k], ys[k], xs[k] + size, ys[k] + size])
        if anomalous_frames is not None and anomalous_frames[0] <= t < anomalous_frames[1]:
            # Anomaly: a larger square with per-frame random texture —
            # uncompletable from temporal context by construction.
            ax = w / 4 + (w / 3) * np.sin(t / 3.0)
            ay = h / 4 + (h / 3) * abs(np.cos(t / 2.0))
            ax = float(np.clip(ax, 0, w - 2 * size))
            ay = float(np.clip(ay, 0, h - 2 * size))
            tex = rng.integers(0, 256, (2 * size, 2 * size, 3), dtype=np.uint8)
            x0, y0 = int(round(ax)), int(round(ay))
            frames[t, y0 : y0 + 2 * size, x0 : x0 + 2 * size] = tex
            frame_boxes.append([ax, ay, ax + 2 * size, ay + 2 * size])
            labels[t] = 1
        boxes.append(np.array(frame_boxes, dtype=np.float32))
    return frames, boxes, labels


def make_synthetic_dataset(
    root: Optional[str] = None,
    name: str = "synthetic",
    n_train_videos: int = 2,
    n_test_videos: int = 2,
    frames_per_video: int = 24,
    frame_h: int = 48,
    frame_w: int = 64,
    seed: int = 0,
    write_to_disk: bool = False,
) -> SyntheticDataset:
    rng = np.random.default_rng(seed)

    train_frames, train_boxes = [], []
    train_lengths = []
    for _ in range(n_train_videos):
        f, b, _ = _make_video(rng, frames_per_video, frame_h, frame_w)
        train_frames.append(f)
        train_boxes += b
        train_lengths.append(frames_per_video)

    test_frames, test_boxes, test_labels = [], [], []
    test_lengths = []
    for vi in range(n_test_videos):
        anom = (frames_per_video // 3, 2 * frames_per_video // 3) if vi % 2 == 0 else None
        f, b, l = _make_video(rng, frames_per_video, frame_h, frame_w, anom)
        test_frames.append(f)
        test_boxes += b
        test_labels.append(l)
        test_lengths.append(frames_per_video)

    ds = SyntheticDataset(
        root=root or "",
        name=name,
        frame_h=frame_h,
        frame_w=frame_w,
        train_frames=np.concatenate(train_frames),
        test_frames=np.concatenate(test_frames),
        test_labels=np.concatenate(test_labels),
        train_boxes=train_boxes,
        test_boxes=test_boxes,
        train_video_lengths=np.array(train_lengths),
        test_video_lengths=np.array(test_lengths),
    )

    if write_to_disk:
        assert root is not None
        import cv2

        off = 0
        for vi, ln in enumerate(train_lengths):
            vdir = os.path.join(root, "Train", f"Train{vi + 1:03d}")
            os.makedirs(vdir, exist_ok=True)
            for t in range(ln):
                cv2.imwrite(os.path.join(vdir, f"{t + 1:03d}.tif"), ds.train_frames[off + t])
            off += ln
        off = 0
        for vi, ln in enumerate(test_lengths):
            vdir = os.path.join(root, "Test", f"Test{vi + 1:03d}")
            gdir = os.path.join(root, "Test", f"Test{vi + 1:03d}_gt")
            os.makedirs(vdir, exist_ok=True)
            os.makedirs(gdir, exist_ok=True)
            for t in range(ln):
                cv2.imwrite(os.path.join(vdir, f"{t + 1:03d}.tif"), ds.test_frames[off + t])
                mask = np.full((frame_h, frame_w), 255 * int(ds.test_labels[off + t]), np.uint8)
                cv2.imwrite(os.path.join(gdir, f"{t + 1:03d}.bmp"), mask)
            off += ln
    return ds
