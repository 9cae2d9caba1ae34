"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program: top-level module names compared whole, since
vec_vad_torch begins with the letters of vec_vad_tpu."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

RUN_TINY = """
import json, sys, time
sys.path.insert(0, {tests!r})
from conftest import tiny
from vadbench.run import run_cell, forbidden_modules
for name in {cells!r}:
    cell, config, e2e, per_layer = tiny(name)
    run_cell(cell, config, 77, 0.1, 1, e2e, per_layer, device="cpu",
             t_start=time.perf_counter())
print(json.dumps({{"forbidden": forbidden_modules(),
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

REFERENCE_ONLY = """
import json, sys
import vadbench.reference, vadbench.reference.ensemble, vadbench.reference.flownet2
import vadbench.reference.scoring, vadbench.reference.ops
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _python(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_nor_the_jax_package():
    from conftest import CELLS

    got = _python(RUN_TINY.format(tests=str(ROOT / "vadbench" / "tests"), cells=list(CELLS)))
    assert got["forbidden"] == []
    assert "vec_vad_torch" in got["tops"]  # the program did run
    for name in ("jax", "jaxlib", "flax", "vec_vad_tpu"):
        assert name not in got["tops"]


def test_the_reference_loads_nothing_of_the_program():
    tops = _python(REFERENCE_ONLY)
    for name in ("vec_vad_torch", "vec_vad_tpu", "jax", "jaxlib", "flax"):
        assert name not in tops


def test_forbidden_names_compare_whole(monkeypatch):
    from vadbench import run

    monkeypatch.setitem(sys.modules, "vec_vad_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "vec_vad_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vec_vad_tpu.models", sys)
    assert run.forbidden_modules() == ["vec_vad_tpu"]
