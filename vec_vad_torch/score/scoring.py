"""Score constants and host helpers (a copy of what serving needs from
vec_vad_tpu/score/scoring.py; reference semantics test.py:269-358)."""

from __future__ import annotations

import numpy as np

BIG_NUMBER = 100000.0  # test.py:196


def degenerate_boxes(boxes: np.ndarray) -> np.ndarray:
    """Boxes whose integer-ceil crop region is empty. The reference still
    scores such cubes but their mask splat covers zero pixels
    (test.py:354-356), so they never influence the frame max."""
    x0 = np.ceil(boxes[:, 0])
    y0 = np.ceil(boxes[:, 1])
    x1 = np.ceil(boxes[:, 2])
    y1 = np.ceil(boxes[:, 3])
    return (x1 <= x0) | (y1 <= y0)
