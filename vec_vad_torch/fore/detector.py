"""Foreground boxes from the shipped bbox fixtures
(vec_vad_tpu/fore/detector.py:40-50).

Only `PrecomputedDetector` is ported: it serves the final bbox fixtures
(raw_datasets/*/bboxes_*_obj_det_with_motion.npy), the reference's
supported way to run without mmdet. Computing boxes from frames
(`compute_foreground_bboxes`, the motion maps and the appearance
detectors) is ROADMAP item 4.1.
"""

from __future__ import annotations

import numpy as np


class PrecomputedDetector:
    """Serves per-frame boxes from a saved object-array .npy fixture."""

    def __init__(self, path: str):
        self.all_boxes = list(np.load(path, allow_pickle=True))

    def __len__(self) -> int:
        return len(self.all_boxes)

    def boxes_for_frame(self, idx: int) -> np.ndarray:
        return np.asarray(self.all_boxes[idx]).reshape(-1, 4)
