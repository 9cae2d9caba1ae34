"""Time phases of a checkout's chip_smoke.py alone on the card.

    python3 chip_phase_times.py [--root DIR] PHASE [PHASE ...]

PHASE names a function of DIR's chip_smoke.py that takes no argument
(`grid_phase`, `serving_surface_phase`, `mesh_phase`, ...). The script
imports chip_smoke and vec_vad_torch from DIR (default: the directory of
this file), sets up as chip_smoke.main does (TF32 off, K1 and K2 built),
runs each phase once with its checks and prints its wall seconds and the
card's nvidia-smi line. To compare two commits, unpack the parent into a
directory that .gitignore lists and run parent, change, change, parent
in one call, one process each:

    for r in build/parent . . build/parent; do
        python3 chip_phase_times.py --root $r grid_phase serving_surface_phase
    done
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_phase_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as s

    print(f"card: {s.card_line()}; root {root}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    s.kernels.build_kernels(["correlation", "correlation_bwd"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    secs = {}
    for name in args.phases:
        t0 = time.perf_counter()
        getattr(s, name)()
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t0, 1)
        print(f"phase {name}: {secs[name]} s wall", flush=True)
    print(json.dumps({"root": str(root), "seconds": secs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
