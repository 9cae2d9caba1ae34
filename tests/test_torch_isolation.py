"""vec_vad_torch stands alone: it imports with jax/flax/optax/vec_vad_tpu
blocked, its sources import none of them, its entry points refuse to run
without a card unless asked for the CPU, and its copied host modules
equal the JAX package's."""

import dataclasses
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vec_vad_torch
import vec_vad_tpu  # noqa: F401  (tests hold the port against it)
from vec_vad_torch import kernels
from vec_vad_torch.models.flownet import ops as tops

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "vec_vad_torch"
FORBIDDEN = ("jax", "flax", "optax", "vec_vad_tpu")


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages([str(PKG)], prefix="vec_vad_torch.")
    )


def test_every_module_imports_with_jax_blocked():
    mods = ["vec_vad_torch"] + _port_modules()
    assert "vec_vad_torch.serve.live_flow" in mods
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
        + "import importlib\n"
        + f"for m in {mods!r}:\n    importlib.import_module(m)\n"
        + "print('ok', len(sys.modules))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_sources_import_nothing_of_jax():
    pat = re.compile(
        r"^\s*(import|from)\s+(%s)\b" % "|".join(FORBIDDEN), re.MULTILINE
    )
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    """Without a card, device='cuda' (the default) raises; device='cpu'
    runs. No entry point falls back to the CPU by itself."""
    from vec_vad_torch.cli import main as cli_main
    from vec_vad_torch.config import CompletionConfig, PipelineConfig
    from vec_vad_torch.flow.trainer import FlowTrainer
    from vec_vad_torch.models.completion import make_completion_net
    from vec_vad_torch.models.flownet import FlowNet2, FlowNet2C
    from vec_vad_torch.serve import StreamingScorer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PipelineConfig(model=CompletionConfig(nf=4, use_flow=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vec_vad_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlowNet2()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_completion_net(cfg.model)
    net = make_completion_net(cfg.model, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingScorer(cfg, net.state_dict(), (0.0, 1.0))
    sc = StreamingScorer(cfg, net.state_dict(), (0.0, 1.0), device="cpu")
    assert sc.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlowNet2C()
    flow_net = FlowNet2C(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlowTrainer(flow_net)
    assert FlowTrainer(flow_net, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["flow-train", "--data-root", ".", "--workdir", ".",
                  "--net", "FlowNetC"])


def test_correlation_wrapper_routes_by_device():
    """CPU tensors take the plain version (no launch counted); tensors on
    any other device go to the kernel path, which raises rather than fall
    back when it cannot launch."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(1, 5, 6, 4)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(1, 5, 6, 4)).astype(np.float32))
    kernels.reset_launch_counts()
    out = tops.correlation(a, b, 2, 1)
    torch.testing.assert_close(out, tops.correlation_ref(a, b, 2, 1),
                               rtol=0, atol=0)
    assert kernels.launch_counts["correlation"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        tops.correlation(a.to("meta"), b.to("meta"), 2, 1)


def test_config_copy_matches_jax_package(tmp_path):
    """config.py is a copy: same dataclasses, defaults, dataset table and
    INI loader results."""
    from vec_vad_tpu import config as jcfg
    from vec_vad_torch import config as tcfg

    for name in ("DatasetSpec", "ForegroundConfig", "CompletionConfig",
                 "PipelineConfig"):
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jcfg, name))
              if f.default is not dataclasses.MISSING]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tcfg, name))
              if f.default is not dataclasses.MISSING]
        assert jf == tf, name
    assert {k: dataclasses.asdict(v) for k, v in jcfg.DATASETS.items()
            if k in tcfg.DATASETS} == {
        k: dataclasses.asdict(v) for k, v in tcfg.DATASETS.items()
    }
    for ctx_of, flow in ((0, True), (4, True), (2, False)):
        jc = jcfg.CompletionConfig(context_of_num=ctx_of, use_flow=flow)
        tc = tcfg.CompletionConfig(context_of_num=ctx_of, use_flow=flow)
        for prop in ("tot_raw_num", "tot_of_num", "resolved_raw_range",
                     "raw_of_offset"):
            assert getattr(jc, prop) == getattr(tc, prop)

    ini = tmp_path / "config.cfg"
    ini.write_text(
        "[shared_parameters]\ndataset_name = avenue\n"
        "[avenue]\npatch_size = 32\nh_block = 2\nw_block = 3\n"
        "motionThr = 0.5\n"
        "[SelfComplete]\nnf = 16\ncontext_of_num = 0\nrawRange = 3\n"
    )
    assert dataclasses.asdict(jcfg.load_ini_config(str(ini))) == \
        dataclasses.asdict(tcfg.load_ini_config(str(ini)))


def test_host_copies_match_jax_package():
    """calc_block_idx, degenerate_boxes, _predict_window and the synthetic
    dataset generator equal their JAX-package originals."""
    from vec_vad_torch.data.synthetic import make_synthetic_dataset as t_syn
    from vec_vad_torch.score.scoring import degenerate_boxes as t_deg
    from vec_vad_torch.serve._common import _predict_window as t_win
    from vec_vad_torch.utils.blocks import calc_block_idx as t_blk
    from vec_vad_tpu.data.synthetic import make_synthetic_dataset as j_syn
    from vec_vad_tpu.score.scoring import degenerate_boxes as j_deg
    from vec_vad_tpu.serve._common import _predict_window as j_win
    from vec_vad_tpu.utils.blocks import calc_block_idx as j_blk

    rng = np.random.default_rng(1)
    boxes = rng.uniform(0, 60, (50, 4)).astype(np.float32)
    np.testing.assert_array_equal(t_deg(boxes), j_deg(boxes))
    for mode in (1, 2, 9):
        for b in boxes[:10]:
            args = (b[0], b[2], b[1], b[3], 24.0, 32.0, mode)
            assert sorted(t_blk(*args)) == sorted(j_blk(*args))
    for pos in range(7):
        for ctx in (0, 1, 4):
            np.testing.assert_array_equal(t_win(pos, ctx), j_win(pos, ctx))
    a, b = t_syn(seed=3, frames_per_video=6), j_syn(seed=3, frames_per_video=6)
    np.testing.assert_array_equal(a.test_frames, b.test_frames)
    for x, y in zip(a.test_boxes, b.test_boxes):
        np.testing.assert_array_equal(x, y)


def test_kernel_sources_build_by_content():
    """Every csrc source has its own library name, keyed by its content,
    under the ignored build directory (nothing is built here)."""
    names = sorted(p.stem for p in (PKG / "csrc").glob("*.cu"))
    assert names == ["correlation", "correlation_bwd"]
    for name in names:
        path = kernels._lib_path(name)
        assert path.parent == ROOT / "build" / "kernels"
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
