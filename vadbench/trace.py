"""The traced run's reductions: torch.profiler's device intervals on the
card reduced to busy time, time by kernel name, and idle gaps labelled
by the harness span that was open on the host at the time.

Harness spans are `torch.profiler.record_function` ranges named
`vadbench.<span>` around the calls into the program (and around the
harness's own host work between them), so a gap on the device can be
told apart as the program's host time or the harness's.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN_PREFIX = "vadbench."


def _union_us(spans) -> float:
    """Length of the union of sorted (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]] = field(default_factory=dict)  # name -> (s, count)
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest first
    intervals: List[Tuple[float, float, str]] = field(default_factory=list)  # us, sorted

    def union_s(self, *patterns: str) -> float:
        """Seconds in which a device operation whose name holds any
        pattern (case-insensitive) ran: the union of their intervals."""
        pats = [p.lower() for p in patterns]
        return _union_us((a, b) for a, b, n in self.intervals
                         if any(p in n.lower() for p in pats)) * 1e-6

    def kernel_s(self, *patterns: str) -> Tuple[float, int]:
        """Seconds and launches of the kernels whose name holds any pattern."""
        s, n = 0.0, 0
        for name, (t, c) in self.kernels.items():
            if any(p in name for p in patterns):
                s += t
                n += c
        return s, n

    def device_s(self) -> float:
        return sum(t for t, _ in self.kernels.values())


def summarise(prof, window_s: float) -> TraceSummary:
    """Reduce a finished torch.profiler.profile over the window."""
    from torch.autograd import DeviceType

    seen, spans = set(), []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(("aten::", SPAN_PREFIX)):
                continue  # an op's device total, or a span's device extent
            # one operation seen twice (under two parents) counts once
            seen.add((e.time_range.start, e.time_range.end, e.name))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.time_range.start, e.time_range.end,
                          e.name[len(SPAN_PREFIX):]))
    dev = sorted(seen)
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        k = kernels[name]
        k[0] += (b - a) * 1e-6
        k[1] += 1
    busy = _union_us((a, b) for a, b, _ in dev)
    gaps, end = [], float("-inf")
    for a, b, _ in dev:
        if end > float("-inf") and a > end:
            gaps.append((end, a))
        end = max(end, b)
    spans.sort()
    starts = [s[0] for s in spans]

    def label(a, b):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        best = None  # the innermost (latest-starting) span holding mid
        while i >= 0:
            s0, s1, name = spans[i]
            if s1 >= mid:
                best = name
                break
            i -= 1
        return best or "outside any span"

    named = sorted(((label(a, b), (b - a) * 1e-6) for a, b in gaps),
                   key=lambda g: -g[1])
    return TraceSummary(window_s=window_s, busy_s=busy * 1e-6,
                        kernels={k: (v[0], int(v[1])) for k, v in kernels.items()},
                        gaps=named, intervals=dev)


def breakdown(summary: TraceSummary) -> dict:
    """The contract's optional breakdown: the 10 device operations that
    took most time and the 10 longest idle gaps by host span."""
    ops = sorted(summary.kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[name[:160], t] for name, (t, _) in ops],
            "idle_gaps": [[name, t] for name, t in summary.gaps[:10]]}
