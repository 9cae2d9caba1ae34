"""Spatial block routing: map a bbox to h_block x w_block grid cell(s).

A copy of vec_vad_tpu/utils/blocks.py: `calc_block_idx` for one box on
the host and `calc_block_idx_batched` for a padded (N, 4) box array in
NumPy. Behavioral parity with the reference `calc_block_idx`
(utils.py:5-26): the candidate points are midpoints between the bbox
center and (mode-dependent) anchor points; cell indices truncate toward
zero; duplicates collapse.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def calc_block_idx(
    x_min: float, x_max: float, y_min: float, y_max: float,
    h_step: float, w_step: float, mode: int,
) -> List[Tuple[int, int]]:
    """Return the deduplicated (h_idx, w_idx) cells this bbox routes to."""
    cy, cx = (y_min + y_max) / 2.0, (x_min + x_max) / 2.0
    pts = [(cy, cx)]
    if mode > 1:
        pts += [(y_min, cx), (y_max, cx), (cy, x_min), (cy, x_max)]
    if mode >= 9:
        pts += [(y_min, x_min), (y_max, x_max), (y_max, x_min), (y_min, x_max)]
    # Midpoint between each anchor point and the center (utils.py:9-18).
    cells = set()
    for (py, px) in pts:
        my, mx = (py + cy) / 2.0, (px + cx) / 2.0
        cells.add((int(my / h_step), int(mx / w_step)))
    return list(cells)


def calc_block_idx_batched(
    boxes: np.ndarray, h_step: float, w_step: float, mode: int,
    h_block: int, w_block: int,
) -> np.ndarray:
    """Vectorized block routing for a padded (N, 4) xyxy box array.

    Returns a boolean membership matrix of shape (N, h_block, w_block):
    True where the box routes to that cell. Invalid (padding) boxes should be
    masked out by the caller. Indices are clipped to the grid so padded junk
    can't index out of bounds (real boxes never exceed the grid: centers and
    edge midpoints lie inside the frame).
    """
    x_min, y_min, x_max, y_max = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    cy, cx = (y_min + y_max) / 2.0, (x_min + x_max) / 2.0
    pts_y = [cy]
    pts_x = [cx]
    if mode > 1:
        pts_y += [y_min, y_max, cy, cy]
        pts_x += [cx, cx, x_min, x_max]
    if mode >= 9:
        pts_y += [y_min, y_max, y_max, y_min]
        pts_x += [x_min, x_max, x_min, x_max]
    py = np.stack(pts_y, axis=1)  # (N, P)
    px = np.stack(pts_x, axis=1)
    my = (py + cy[:, None]) / 2.0
    mx = (px + cx[:, None]) / 2.0
    h_idx = np.clip((my / h_step).astype(np.int64), 0, h_block - 1)
    w_idx = np.clip((mx / w_step).astype(np.int64), 0, w_block - 1)
    member = np.zeros((boxes.shape[0], h_block, w_block), dtype=bool)
    n_idx = np.arange(boxes.shape[0])[:, None].repeat(h_idx.shape[1], axis=1)
    member[n_idx.ravel(), h_idx.ravel(), w_idx.ravel()] = True
    return member
