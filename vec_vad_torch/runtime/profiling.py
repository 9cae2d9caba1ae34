"""Tracing and stage timing (vec_vad_tpu/runtime/profiling.py).

  * StageTimer — hierarchical wall-clock stage timing with a report table
    (host code, the JAX package's own);
  * trace() — torch.profiler over a block, its trace written under
    log_dir for TensorBoard or Perfetto (a no-op for None);
  * annotate() — a named region (torch.profiler.record_function), so
    pipeline stages show up by name inside a trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple


class StageTimer:
    """Accumulates named wall-clock spans (TimerBlock, structured)."""

    def __init__(self) -> None:
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}
        self._stack: List[str] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        qual = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            self.totals[qual] = self.totals.get(qual, 0.0) + dt
            self.counts[qual] = self.counts.get(qual, 0) + 1

    def report(self) -> str:
        if not self.totals:
            return "(no stages recorded)"
        width = max(len(k) for k in self.totals)
        lines = [f"{'stage':<{width}}  {'total_s':>9}  {'calls':>5}  {'mean_ms':>9}"]
        for k, v in self.totals.items():
            c = self.counts[k]
            lines.append(f"{k:<{width}}  {v:9.3f}  {c:5d}  {v / c * 1e3:9.2f}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Tuple[float, int]]:
        return {k: (v, self.counts[k]) for k, v in self.totals.items()}


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace of the block, host and (on a card) device
    activity, written under log_dir (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace."""
    from torch.profiler import record_function

    with record_function(name):
        yield
