"""The readings that a cell's limits are set from, many seeds in one
process: for each seed the cell's set-up, a short window, and the
compared numbers of the program against the float32 reference; for the
control seeds also those of each control put in the program's place.
Not run by the benchmark's runs.

    python -m vadbench.control --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--kinds tf32,frozen,half] --seconds 3

Prints one JSON line a seed: {"seed", "program": {...}, "<kind>": {...}}
for each control kind read on that seed (--kinds, default tf32; for a
training cell also "frozen" and "half", the faults its numbers are held
against).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys

from vadbench.run import Run, load_cell, window


def readings(cell, config, seed, seconds, control=(), device="cuda"):
    """{"program": compared numbers, and one entry a kind in `control`
    ("tf32", or for training "frozen" and "half")} of one seed."""
    import torch

    from vadbench.reference import reference_context

    dev = torch.device(device)
    run = Run(cell, config, seed, dev)
    driver = importlib.import_module(f"vadbench.drivers.{cell['driver']}").Driver(run)
    driver.setup()
    window(driver, seconds, torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))
    driver.release()
    out = {"seed": seed}
    with reference_context():
        out["program"] = driver.check()
        for kind in control:
            out[kind] = driver.check(control=kind)
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--kinds", default="tf32",
                    help="controls read on the control seeds: tf32[,frozen,half]")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell, config, _, _ = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds + [s for s in ctrl if s not in seeds]:
        kinds = args.kinds.split(",") if seed in ctrl else []
        out = readings(cell, config, seed, args.seconds, kinds)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
