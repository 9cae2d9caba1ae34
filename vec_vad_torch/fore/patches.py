"""Grid-patch and whole-frame foreground modes (vec_vad_tpu/fore/patches.py).

Parity with fore_det/simple_patch.py:5-16 and the 'frame' branch of
train.py:87-90.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def get_patch_boxes(h: int, w: int, h_num: int, w_num: int) -> np.ndarray:
    """Regular h_num x w_num tiling as xyxy boxes, x-major order (the
    reference iterates itertools.product(x_mins, y_mins))."""
    h_step, w_step = h / h_num, w / w_num
    y_mins = np.linspace(0, h - 1, h_num, endpoint=False)
    x_mins = np.linspace(0, w - 1, w_num, endpoint=False)
    out = []
    for x0 in x_mins:
        for y0 in y_mins:
            out.append(
                [x0, y0, min(x0 + w_step, w - 1), min(y0 + h_step, h - 1)]
            )
    return np.array(out)


def multi_scale_patch_boxes(
    h: int, w: int, patch_nums: Sequence[Tuple[int, int]] = ((3, 4), (6, 8))
) -> np.ndarray:
    """The 'simple_patch' mode's two-scale tiling (train.py:81-86)."""
    return np.concatenate(
        [get_patch_boxes(h, w, hn, wn) for hn, wn in patch_nums], axis=0
    )


def full_frame_box(h: int, w: int) -> np.ndarray:
    """'frame' mode: one box covering the frame (train.py:87-90)."""
    return np.array([[0, 0, w, h]], dtype=np.float64)
