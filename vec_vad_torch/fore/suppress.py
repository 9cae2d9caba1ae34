"""Overlap suppression for appearance boxes (vec_vad_tpu/fore/suppress.py).

Parity with `del_cover_bboxes` (fore_det/obj_det_with_motion.py:94-141):
sort by area ascending; drop a box when its intersection with any LARGER
(later-sorted) box exceeds cover_thr of its own area. This differs from NMS
— the criterion is one-sided coverage of the smaller box.
"""

from __future__ import annotations

import numpy as np


def del_cover_bboxes(boxes: np.ndarray, cover_thr: float) -> np.ndarray:
    """boxes: (N, 4) xyxy; returns the kept subset (original dtype/rows).

    Areas use the reference's inclusive pixel convention
    (x2 - x1 + 1) * (y2 - y1 + 1)."""
    boxes = np.asarray(boxes)
    if boxes.size == 0:
        return boxes.reshape(0, 4)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = areas.argsort()  # ascending

    # Pairwise intersections, computed once.
    ix1 = np.maximum(x1[:, None], x1[None, :])
    iy1 = np.maximum(y1[:, None], y1[None, :])
    ix2 = np.minimum(x2[:, None], x2[None, :])
    iy2 = np.minimum(y2[:, None], y2[None, :])
    inter = np.maximum(0, ix2 - ix1 + 1) * np.maximum(0, iy2 - iy1 + 1)

    keep = []
    for i in range(order.size):
        a = order[i]
        later = order[i + 1 :]
        if later.size == 0 or not np.any(inter[a, later] / areas[a] > cover_thr):
            keep.append(a)
    return boxes[keep]
