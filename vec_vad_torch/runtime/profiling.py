"""Spans and stage timing (vec_vad_tpu/runtime/profiling.py).

  * StageTimer — hierarchical wall-clock stage timing with a report table
    (host code, the JAX package's own);
  * annotate() — the port's spans: a named range,
    `vec_vad_torch.<layer>.<span>`, inside any torch profiler that is
    recording, and nothing but one flag check when none is.

The spans sit where the work happens. Serving (serve/): `serve.tick`
holds a whole `push_tick` (`push`, `push_many`, `end_video`, `drain`)
and, inside it, `serve.stage` (host work and uploads before the first
kernel), `serve.flow` (live FlowNet2 with its resizes), `serve.stc`
(cube extraction), `serve.ensemble` (the completion nets and the score
arithmetic), `serve.wait` (the host blocked on the result's download)
and `serve.finish` (host score routing); the ring writes and window
gathers are the tick's own. On the detecting fleet
(serve/detect_fleet.py) `serve.detect` opens the tick: the Cascade
R-CNN's forward, with `detect.prep` (resize, normalise, pad),
`detect.backbone` (ResNet and FPN), `detect.rpn` (the RPN head and its
NMS), `detect.stages` (the three cascade stages) and `detect.nms` (the
multiclass NMS) inside it (fore/mmdet_detector.py, wherever the
detector runs), its download (`serve.wait`) and `detect.filter` (the
host's score, area and cover filter). Training (`BlockTrainer.fit_block`):
`train.fit` holds `train.init_state`, `train.upload`,
`train.schedule_host`, `train.train_scan`, `train.score_pass` and
`train.param_download`, fit_block_budget's phases. To see them, run
any `torch.profiler.profile` around the calls: the spans are ranges on
its host timeline, on the clock of its device activity, and appear in
`key_averages()` and `export_chrome_trace()` under their names.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Tuple

import torch
import torch.autograd.profiler as _torch_profiler

SPAN_PREFIX = "vec_vad_torch."
_NO_SPAN = contextlib.nullcontext()


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


def annotate(name: str):
    """A context manager that makes the block the span
    `vec_vad_torch.<name>` of a running torch profiler.

    With no profiler recording it is a shared null context: one read of
    the flag torch sets when a profiler starts and clears when it stops,
    no range, no CUDA event, no clock. While one records it is a
    profiler range (`torch._C._profiler._RecordFunctionFast`, the
    function scope torch's own operators take), timed on the profiler's
    clock with the kernels. It is not a user annotation, so it adds no
    device-side event of its own; a kernel belongs to the innermost span
    that holds the runtime call that launched it."""
    if not _torch_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)
