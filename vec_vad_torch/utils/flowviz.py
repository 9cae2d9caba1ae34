"""Middlebury .flo IO, copied from vec_vad_tpu/utils/flowviz.py:99-118
(flowlib.py:84-121). The rest of that module (colour rendering, KITTI
png IO, error metrics) is not ported yet."""

from __future__ import annotations

import numpy as np

TAG_FLOAT = 202021.25


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
