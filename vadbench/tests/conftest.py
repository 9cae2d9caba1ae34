"""Tiny forms of the benchmark's cells for the CPU: the real cells'
files with their sizes cut (frames 48 x 64, patch 16, nf 4, FlowNet2 at
64 x 64, 2 cameras, small blocks), so that every cell runs end
to end here in seconds. Whether there is a card is decided inside tests,
never at import."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("avenue_5raw1of.live_fleet", "ped2_5raw.train", "ped2_5raw.fleet")

TINY_CONFIG = {"frame_hw": [48, 64], "patch_size": 16, "epochs": 2,
               "model": {"nf": 4, "batch_size": 32}, "flow": {"model_hw": [64, 64]}}
TINY_TRAFFIC = {
    "live_fleet": {"cameras": 2, "pool_ticks": 6, "box_side": [8, 24], "warm_ticks": 3,
                   "stats_ticks": 2, "check_ticks": 2},
    "fleet": {"cameras": 2, "pool_ticks": 6, "box_side": [8, 24], "warm_ticks": 3,
              "stats_ticks": 2, "check_ticks": 3},
    "train": {"cubes": 96, "init_pool": 2, "check_calls": 1},
}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        elif k in out:
            out[k] = v
    return out


def tiny(name: str):
    """(cell, config, end-to-end metrics, per-layer metrics) of a cell at
    its CPU size."""
    from vadbench.run import load_cell

    cell, config, e2e, per_layer = load_cell(name)
    cell = _merge(cell, {"traffic": TINY_TRAFFIC[cell["driver"]]})
    return cell, _merge(config, TINY_CONFIG), e2e, per_layer


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
