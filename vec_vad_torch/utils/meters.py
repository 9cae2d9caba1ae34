"""Running-average meter (parity with helper/misc.py:59-75)."""

from __future__ import annotations


class AverageMeter:
    """Tracks the current value, running sum, count and average."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
