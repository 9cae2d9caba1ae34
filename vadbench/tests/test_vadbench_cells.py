"""Every cell end to end at its CPU size (tests/conftest.py's `tiny`), with
the contract's result, and the command's refusals."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import CELLS, ROOT, tiny
from vadbench.run import run_cell

SEED = 2 ** 33 + 12345  # past 32 signed bits, as the checks' seeds are


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_end_to_end(name, trace):
    cell, config, e2e, per_layer = tiny(name)
    result = run_cell(cell, config, SEED, 0.2, trace, e2e, per_layer,
                      device="cpu", t_start=time.perf_counter())
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "compared"
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    if trace == 0:
        assert set(result["metrics"]) == {m["name"] for m in e2e}
        assert all(v["value"] > 0 for v in result["metrics"].values())
    else:
        # off the card only the counter-based readers find something
        assert set(result["metrics"]) <= {m["name"] for m in per_layer}
    for c in result["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card):
    """The same tiny cells on the card, traced (skips without one)."""
    cell, config, e2e, per_layer = tiny(name)
    result = run_cell(cell, config, SEED, 0.5, 1, e2e, per_layer,
                      device=card, t_start=time.perf_counter())
    assert result["correct"], result["compared"]
    assert result["device"]["busy_s"] > 0
    assert "mfu." + {"live_fleet": "serve", "fleet": "serve",
                     "train": "train"}[cell["driver"]] in result["metrics"]


def test_same_seed_same_inputs():
    from vadbench import traffic

    a = traffic.frames(SEED, 3, 2, (24, 32), 3, "cpu")
    b = traffic.frames(SEED, 3, 2, (24, 32), 3, "cpu")
    assert (a == b).all()
    rng = traffic.host_rng(SEED, 1), traffic.host_rng(SEED, 1)
    counts = traffic.box_counts(40, 13, 22, rng[0])
    assert (counts == traffic.box_counts(40, 13, 22, rng[1])).all()
    assert sorted(set(counts)) == list(range(13, 23))
    # every seed gets the same multiset of box counts
    other = traffic.box_counts(40, 13, 22, traffic.host_rng(SEED + 1, 1))
    assert sorted(other) == sorted(counts)


def _command(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "-m", "vadbench.run", "--workload", CELLS[0], "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_command_refuses_without_a_card():
    out = _command(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_command_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vadbench", tmp_path / "vadbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_names_every_cell_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [w["name"] for w in bench["workloads"]]
    assert names == list(CELLS)
    for w in bench["workloads"]:
        cell = json.loads((ROOT / "vadbench" / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"]
        assert (ROOT / "vadbench" / "drivers" / f"{cell['driver']}.py").exists()
    for m in bench["per_layer"]:
        stem = m["name"].split(".")[0]
        assert ((ROOT / "vadbench" / "metrics" / f"{m['name']}.py").exists()
                or (ROOT / "vadbench" / "metrics" / f"{stem}.py").exists())
