"""Spatial block routing: map a bbox to h_block x w_block grid cell(s).

A copy of vec_vad_tpu/utils/blocks.py:calc_block_idx (NumPy-free host
code). Behavioral parity with the reference `calc_block_idx`
(utils.py:5-26): the candidate points are midpoints between the bbox
center and (mode-dependent) anchor points; cell indices truncate toward
zero; duplicates collapse.
"""

from __future__ import annotations

from typing import List, Tuple


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
