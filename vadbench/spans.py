"""The program's own spans in a traced window, and the readings taken
from them, beside the harness's reductions (vadbench/trace.py):

    python -m vadbench.spans --workload <cell> --seed <n> --seconds <s>

runs a cell's set-up and a traced window as `vadbench.run --trace 1`
does (no comparison with the reference), then prints one JSON line: the
readings below, the device time and idle time by program span, and the
spans a tick or a fit holds.

The program names its spans `vec_vad_torch.<layer>.<span>`
(vec_vad_torch/runtime/profiling.annotate): host ranges on the
profiler's clock, with no device-side event of their own. A device
operation belongs to the innermost program span that holds the runtime
call that launched it (the CUDA runtime or driver call with the
operation's correlation id), and a span's
device extent runs from the first to the last operation of it and its
children.

Readings (None where the spans they read are absent, as in a program
without them):
  host_ms.serve          mean over serve.tick of its host length less its
                         serve.wait children's
  idle_host_pct.serve    100 x (device idle between the first and last
                         device operation) within the host intervals of
                         serve.stage and serve.finish, over the window
  idle_host_pct.train    the same for train.init_state, train.schedule_host,
                         train.upload and train.param_download
  stc_ms.serve           device ms a tick: the union of the device
                         operations inside serve.stc's device extents over
                         the serve.tick spans
  ensemble_ms.serve      the same for serve.ensemble
  fit_overhead_pct.train 100 x (train.fit's host length less
                         train.train_scan's) over train.fit's, summed over
                         the window's fits
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

from vadbench.trace import SPAN_PREFIX as HARNESS_PREFIX
from vadbench.trace import TraceSummary, _union_us

PROGRAM_PREFIX = "vec_vad_torch."
RUNTIME = "cu"  # cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...
HOST_SERVE = ("serve.stage", "serve.finish")
HOST_TRAIN = ("train.init_state", "train.schedule_host", "train.upload",
              "train.param_download")

Span = Tuple[float, float, str, str]  # (start us, end us, name, "host" | "device")


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA


def _nest(spans: List[Tuple[float, float, str]]):
    """Sort host spans of one thread (properly nested) outer before inner,
    and give each its parent's index (None at the top)."""
    spans.sort(key=lambda s: (s[0], -s[1]))
    parents, stack = [], []
    for i, (a, _, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= a:
            stack.pop()
        parents.append(stack[-1] if stack else None)
        stack.append(i)
    return [a for a, _, _ in spans], parents


def _innermost(spans, starts, parents, t: float) -> Optional[int]:
    """Index of the innermost of the nested spans that holds time t, or
    None: the latest to start at or before t, or the nearest of its
    ancestors that is still open at t."""
    i = bisect.bisect_right(starts, t) - 1
    while i is not None and i >= 0 and spans[i][1] < t:
        i = parents[i]
    return None if i is None or i < 0 else i


def program_spans(events, routes: Optional[Counter] = None) -> List[Span]:
    """The program's spans among a finished profiler's events: each host
    span, and the device extent of each one that launched device work,
    on the profiler's one clock, in start order. `routes` counts the
    device operations whose runtime call was found ("runtime") and
    those left out for want of one ("none")."""
    host, runtime, device = [], {}, []
    for e in events:
        if _is_device(e):
            if not e.name.startswith(("aten::", HARNESS_PREFIX, PROGRAM_PREFIX)):
                device.append(e)
        elif e.name.startswith(PROGRAM_PREFIX):
            host.append((e.time_range.start, e.time_range.end,
                         e.name[len(PROGRAM_PREFIX):]))
        elif e.name.startswith(RUNTIME):
            # a CUDA runtime or driver call carries its launch's correlation
            # id (operators number their own ids apart)
            runtime[e.id] = e
    starts, parents = _nest(host)
    routes = Counter() if routes is None else routes
    extent: Dict[int, List[float]] = {}
    for d in device:
        launch = runtime.get(d.id)
        routes["runtime" if launch is not None else "none"] += 1
        if launch is None:
            continue
        i = _innermost(host, starts, parents, launch.time_range.start)
        while i is not None:  # the span and every span around it
            x = extent.setdefault(i, [d.time_range.start, d.time_range.end])
            x[0] = min(x[0], d.time_range.start)
            x[1] = max(x[1], d.time_range.end)
            i = parents[i]
    out = [(a, b, n, "host") for a, b, n in host]
    out += [(x[0], x[1], host[i][2], "device") for i, x in extent.items()]
    return sorted(out)


def _select(spans, name: str, side: str) -> List[Tuple[float, float]]:
    return sorted((a, b) for a, b, n, s in spans if n == name and s == side)


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap_us(xs, ys) -> float:
    """Length of (union of xs) intersected with (union of ys)."""
    xs, ys = _merged(xs), _merged(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        (a, b), (c, d) = xs[i], ys[j]
        total += max(0.0, min(b, d) - max(a, c))
        if b < d:
            i += 1
        else:
            j += 1
    return total


def _idle_us(summary: TraceSummary) -> List[Tuple[float, float]]:
    """The device's idle intervals between its first and last operation."""
    idle, end = [], float("-inf")
    for a, b, _ in summary.intervals:
        if end > float("-inf") and a > end:
            idle.append((end, a))
        end = max(end, b)
    return idle


def _inside_us(summary: TraceSummary, extents) -> float:
    """Length of the union of the device operations that lie inside one
    of the (sorted, disjoint) extents."""
    starts = [x0 for x0, _ in extents]
    inside = []
    for a, b, _ in summary.intervals:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and b <= extents[i][1]:
            inside.append((a, b))
    return _union_us(inside)


def host_ms(spans) -> Optional[float]:
    ticks = _select(spans, "serve.tick", "host")
    if not ticks:
        return None
    waits = _select(spans, "serve.wait", "host")
    own = sum(b - a for a, b in ticks) - _overlap_us(waits, ticks)
    return own / len(ticks) * 1e-3


def idle_host_pct(summary: TraceSummary, spans, names) -> Optional[float]:
    host = [iv for n in names for iv in _select(spans, n, "host")]
    if summary is None or not host or summary.window_s <= 0:
        return None
    return 100.0 * _overlap_us(_idle_us(summary), host) * 1e-6 / summary.window_s


def device_ms_a_tick(summary: TraceSummary, spans, name: str) -> Optional[float]:
    extents = _merged(_select(spans, name, "device"))
    ticks = len(_select(spans, "serve.tick", "host"))
    if summary is None or not extents or not ticks:
        return None
    return _inside_us(summary, extents) * 1e-3 / ticks


def fit_overhead_pct(spans) -> Optional[float]:
    fits = _select(spans, "train.fit", "host")
    scans = _select(spans, "train.train_scan", "host")
    if not fits or not scans:
        return None
    total = sum(b - a for a, b in fits)
    return 100.0 * (total - sum(b - a for a, b in scans)) / total


def readings(summary: TraceSummary, spans) -> Dict[str, Optional[float]]:
    return {
        "host_ms.serve": host_ms(spans),
        "idle_host_pct.serve": idle_host_pct(summary, spans, HOST_SERVE),
        "idle_host_pct.train": idle_host_pct(summary, spans, HOST_TRAIN),
        "stc_ms.serve": device_ms_a_tick(summary, spans, "serve.stc"),
        "ensemble_ms.serve": device_ms_a_tick(summary, spans, "serve.ensemble"),
        "fit_overhead_pct.train": fit_overhead_pct(spans),
    }


def idle_by_span(summary: TraceSummary, spans, harness) -> Dict[str, float]:
    """Device-idle seconds by the innermost span open on the host at the
    time: a program span, else a harness span ("harness <name>"), else
    "outside any span". The harness's spans hold the program's calls, so
    the two nest as one."""
    nested = [(a, b, n) for a, b, n, s in spans if s == "host"]
    nested += [(a, b, "harness " + n) for a, b, n in harness]
    starts, parents = _nest(nested)
    bounds = sorted({t for a, b, _ in nested for t in (a, b)})
    segments = []  # (start, end, label) of the host timeline between bounds
    for a, b in zip(bounds, bounds[1:]):
        i = _innermost(nested, starts, parents, 0.5 * (a + b))
        segments.append((a, b, "outside any span" if i is None else nested[i][2]))
    idle: Dict[str, float] = defaultdict(float)
    for a, b in _idle_us(summary):
        covered = 0.0
        for k in range(max(bisect.bisect_right(bounds, a) - 1, 0), len(segments)):
            s0, s1, label = segments[k]
            if s0 >= b:
                break
            part = max(0.0, min(b, s1) - max(a, s0))
            idle[label] += part * 1e-6
            covered += part
        idle["outside any span"] += (b - a - covered) * 1e-6
    return {k: v for k, v in idle.items() if v > 0}


def device_s_by_span(summary: TraceSummary, spans) -> Dict[str, float]:
    """Device seconds inside each program span's device extents (a span
    with children counts theirs too)."""
    names = sorted({n for _, _, n, s in spans if s == "device"})
    return {n: _inside_us(summary, _merged(_select(spans, n, "device"))) * 1e-6
            for n in names}


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys

    from vadbench.run import ROOT, load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    # the conditions vadbench.run sets before torch loads
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    if not torch.cuda.is_available():
        print("vadbench.spans: needs a CUDA device", file=sys.stderr)
        return 3
    cell, config, _, _ = load_cell(args.workload)
    out = traced(cell, config, args.seed, args.seconds, torch.device("cuda"))
    print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


def traced(cell, config, seed: int, seconds: float, device) -> dict:
    """One traced window of a cell, reduced to the harness's summary and
    the program's spans."""
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vadbench.run import Run, window
    from vadbench.trace import summarise

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    driver = importlib.import_module(f"vadbench.drivers.{cell['driver']}").Driver(
        Run(cell, config, seed, device))
    driver.setup()
    sync()
    limit = min(seconds, float(cell["traffic"].get("trace_seconds", seconds)))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with driver.trace_hooks(), profile(activities=acts) as prof:
        steps, window_s = window(driver, limit, sync)
    events = prof.events()
    summary = summarise(prof, window_s)
    routes = Counter()
    spans = program_spans(events, routes)
    harness = [(e.time_range.start, e.time_range.end, e.name[len(HARNESS_PREFIX):])
               for e in events
               if not _is_device(e) and e.name.startswith(HARNESS_PREFIX)]
    # device-side user annotations (torch's own record_function ranges)
    # that the harness's summary counted as device operations
    annotations = {e.name for e in events
                   if _is_device(e) and getattr(e, "is_user_annotation", False)}
    host_s = defaultdict(float)
    for a, b, n, side in spans:
        if side == "host":
            host_s[n] += (b - a) * 1e-6
    calls = sum(1 for _, _, n, s in spans if s == "host" and n in ("serve.tick", "train.fit"))
    out = {
        "seed": seed, "steps": len(steps), "window_s": window_s,
        "busy_s": summary.busy_s,
        "device_idle_pct": 100.0 * (1.0 - summary.busy_s / window_s),
        "readings": readings(summary, spans),
        "idle_s_by_span": idle_by_span(summary, spans, harness),
        "device_s_by_span": device_s_by_span(summary, spans),
        "spans_a_call": (sum(1 for s in spans if s[3] == "host") / calls) if calls else None,
        "attribution_routes": dict(routes),
        "program_names_in_kernels": [k for k in summary.kernels
                                     if k.startswith(PROGRAM_PREFIX)],
        "annotations_in_kernels": {n: summary.kernels[n] for n in sorted(annotations)
                                   if n in summary.kernels},
        "busy_s_without_annotations": _union_us(
            (a, b) for a, b, n in summary.intervals if n not in annotations) * 1e-6,
        "host_s_by_span": dict(host_s),
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
    }
    driver.release()
    return out


if __name__ == "__main__":
    raise SystemExit(main())
