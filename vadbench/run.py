"""Run one benchmark cell of vec_vad_torch once, on the card:

    python -m vadbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, vadbench/ and the
program (vec_vad_torch/). The cell's file, vadbench/workloads/<cell>.json,
names its configuration, its driver (vadbench/drivers/<driver>.py), its
traffic parameters and the limits of its comparison with the reference.

A run: set-up (imports, inputs and weights from the seed, the program's
objects, warm-up of every shape the cell uses), then a window of closed-
loop steps for `--seconds` (the last step started inside it ends it),
then the peak memory, then the program's state freed and its outputs
compared with the plain reference (vadbench/reference/). The last line
of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1), device, with --trace 1 a breakdown, and last the
compared numbers beside their limits, which also end standard error.

--trace 1 runs the window under torch.profiler (for at most the cell's
`trace_seconds`) with the drivers' trace hooks, and reads each per-layer
metric with its reader, vadbench/metrics/<name>.py (or <stem>.py for a
name <stem>.<suffix>).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vec_vad_tpu")
PROGRAM = "vec_vad_torch"


class Run:
    """What a driver is handed: the cell's traffic parameters, its
    configuration, the seed and the device."""

    def __init__(self, cell, config, seed, device):
        self.traffic, self.config = cell["traffic"], config
        self.seed, self.device = int(seed), device


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT):
    """(cell, config, end-to-end metrics, per-layer metrics) of a cell."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    if cell["config"] != entry["config"]:
        raise SystemExit(f"{name}: its file names config {cell['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if applies(m, name)]
    return cell, config, e2e, per_layer


def _reader(name: str):
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"vadbench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for per-layer metric {name!r} in vadbench/metrics/")


def _sum_work(steps):
    work = {}
    for s in steps:
        for k, v in s.get("work", {}).items():
            work[k] = work.get(k, 0) + v
    return work


def window(driver, seconds: float, sync):
    """Closed-loop steps until `seconds` have passed; (steps, window s)."""
    import torch

    steps = []
    sync()
    t0 = time.perf_counter()
    while True:
        with torch.profiler.record_function("vadbench.step"):
            steps.append(driver.step())
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return steps, time.perf_counter() - t0


def run_cell(cell, config, seed, seconds, trace, e2e, per_layer,
             device="cuda", chips=1, t_start=None):
    """One run of a cell: the result that the command prints."""
    import torch

    from vadbench.reference import reference_context

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run = Run(cell, config, seed, dev)
    driver = importlib.import_module(f"vadbench.drivers.{cell['driver']}").Driver(run)

    driver.setup()
    sync()
    setup_s = time.perf_counter() - (t_start if t_start is not None else T_START)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    summary, records = None, {}
    if not trace:
        steps, window_s = window(driver, seconds, sync)
    else:
        from torch.profiler import ProfilerActivity, profile

        from vadbench.trace import summarise

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        limit = min(seconds, float(cell["traffic"].get("trace_seconds", seconds)))
        with driver.trace_hooks() as records, profile(activities=acts) as prof:
            steps, window_s = window(driver, limit, sync)
        records = dict(records)
        if cuda:
            summary = summarise(prof, window_s)
            print(f"trace: {len(summary.intervals)} device operations, "
                  f"{summary.device_s():.3f} s summed, {summary.busy_s:.3f} s busy "
                  f"(union), window {window_s:.3f} s", file=sys.stderr)
        del prof
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    attempted = len(steps)
    failed = sum(1 for s in steps if not s["ok"])
    if not trace:
        values = driver.end_to_end(steps, window_s)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in e2e}
    else:
        rec = {"summary": summary, "window_s": window_s, "work": _sum_work(steps),
               "config": config, "cell": cell, "driver": records}
        metrics = {}
        for m in per_layer:
            v = _reader(m["name"])(rec, m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    driver.release()
    with reference_context():
        readings = driver.check()
    limits = cell["limits"]
    compared = {k: {"value": float(v), "limit": float(limits[k])}
                for k, v in readings.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": _device(dev, chips, memory_peak, summary)}
    if summary is not None:
        from vadbench.trace import breakdown

        result["breakdown"] = breakdown(summary)
    result["compared"] = compared
    return result


def _device(dev, chips, memory_peak, summary):
    import torch

    out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(memory_peak)}
    if summary is not None:
        out["busy_s"] = summary.busy_s
        out["window_s"] = summary.window_s
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (vec_vad_torch begins with the letters of vec_vad_tpu)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _program_in_checkout() -> bool:
    spec = importlib.util.find_spec(PROGRAM)
    return (spec is not None and spec.origin is not None
            and Path(spec.origin).resolve().is_relative_to(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches of the program inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    # one host thread for the process's CPU work (the staging copies of
    # a tick are small): a thread pool's wake-ups on a shared host only
    # add jitter to the tick times
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if not _program_in_checkout():
        print(f"vadbench: the program {PROGRAM} is not in this checkout", file=sys.stderr)
        return 2
    import torch

    cell, config, e2e, per_layer = load_cell(args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vadbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    card = power_limit()
    result = run_cell(cell, config, args.seed, args.seconds,
                      args.trace, e2e, per_layer, device="cuda", chips=chips)
    found = forbidden_modules()
    if found:
        print(f"vadbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    print(f"card: {card}", file=sys.stderr)
    for k, c in result["compared"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"compared {k} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
