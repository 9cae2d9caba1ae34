"""vec_vad_torch stands alone: it imports with jax/flax/optax/vec_vad_tpu
blocked, its sources import none of them, its entry points refuse to run
without a card unless asked for the CPU, and its copied host modules
equal the JAX package's."""

import ast
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
    for m in ("train.trainer", "infer", "eval.metrics", "fore.detector", "runner",
              "runtime.native_loader", "runtime.layer_profile", "utils.png",
              "utils.visualize", "utils.flowviz", "utils.gradtap", "utils.meters"):
        assert f"vec_vad_torch.{m}" in mods
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
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "chip_phase_times.py"]
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


def test_grid_and_interop_entry_points_need_a_card(monkeypatch, tmp_path):
    """The model grid's and the interop's entry points: device='cuda' (the
    default) raises without a card, device='cpu' runs."""
    from vec_vad_torch import demo
    from vec_vad_torch.config import CompletionConfig, PipelineConfig
    from vec_vad_torch.infer import infer_frame_scores_grid
    from vec_vad_torch.models.completion_convert import import_model_grid
    from vec_vad_torch.models.completion_export import export_model_grid
    from vec_vad_torch.pipeline import CubeSet, TrainedBlock, VadModel
    from vec_vad_torch.train.grid_trainer import GridTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PipelineConfig(model=CompletionConfig(nf=4, use_flow=False))
    cubes = CubeSet(np.zeros((2, 16, 16, 15), np.uint8), None, np.zeros(2, np.int64),
                    np.zeros((2, 4), np.float32), np.zeros((2, 2), np.int64),
                    np.ones(2, np.int64))
    calls = [
        lambda **k: GridTrainer(cfg.model, 16, **k),
        lambda **k: infer_frame_scores_grid(VadModel(cfg=cfg), cubes, 2, **k),
        lambda **k: import_model_grid(cfg, str(tmp_path), **k),
        lambda **k: demo.main(base=str(tmp_path / "demo"), **k),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert GridTrainer(cfg.model, 16, device="cpu").device.type == "cpu"
    assert infer_frame_scores_grid(VadModel(cfg=cfg), cubes, 2, device="cpu").shape == (2,)
    with pytest.raises(FileNotFoundError):  # runs as far as reading the files
        import_model_grid(cfg, str(tmp_path), device="cpu")
    state = GridTrainer(cfg.model, 16, device="cpu").solo.init_state(0)
    model = VadModel(cfg=cfg, blocks={(0, 0, 0): TrainedBlock(state, np.ones(3), None)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model_grid(model, str(tmp_path / "out"))
    assert len(export_model_grid(model, str(tmp_path / "out"), device="cpu")) == 3


def test_tooling_entry_points_need_a_card(monkeypatch):
    """The layer profiler's probes and warp_image_np run on the card by
    default and raise without one; device='cpu' runs."""
    from vec_vad_torch.runtime import layer_profile as lp
    from vec_vad_torch.utils.flowviz import warp_image_np

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, flow = np.zeros((4, 5, 3)), np.zeros((4, 5, 2))
    calls = [
        lambda **k: lp.profile_unet_convs(batch=1, iters=1, shapes=[("t", 4, 3, 4)], **k),
        lambda **k: lp.profile_ensemble_formulations(batch=1, members=2, H=4, C=4,
                                                     iters=1, **k),
        lambda **k: lp.ensemble_formulation_outputs(batch=1, members=2, H=4, C=4, **k),
        lambda **k: lp.profile_completion_program(batches=(1,), dtypes=(torch.float32,),
                                                  mode="fwd", iters=1, **k),
        lambda **k: warp_image_np(img, flow, **k),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    np.testing.assert_array_equal(warp_image_np(img, flow, device="cpu"), img)
    assert set(lp.ensemble_formulation_outputs(batch=1, members=2, H=4, C=4,
                                               device="cpu")) == {
        "vmap", "grouped", "blockdiag", "sharedw_batch"}


def test_mesh_entry_points_need_a_card(monkeypatch):
    """The device mesh (vec_vad_torch/parallel) imports nothing of JAX and
    has no CPU fallback: get_mesh() and a mesh of cards raise without a
    card, and the CPU is a mesh entry only when named."""
    from vec_vad_torch import parallel
    from vec_vad_torch.config import CompletionConfig
    from vec_vad_torch.train.trainer import BlockTrainer

    assert "vec_vad_torch.parallel.mesh" in _port_modules()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.get_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockTrainer(CompletionConfig(nf=4, use_flow=False), 16, mesh=["cuda", "cuda"])
    assert parallel.get_mesh(device="cpu").devices == (torch.device("cpu"),)
    mesh = parallel.get_mesh(["cpu", "cpu"])
    assert mesh.size == 2 and parallel.as_mesh("cpu").size == 1


def test_decoder_is_the_ports_own():
    """The frame decoder builds from vec_vad_torch/csrc/vadio.cpp into the
    ignored build directory, named by its content; no source of the port
    loads the JAX package's native/libvadio.so."""
    from vec_vad_torch.runtime import native_loader as nl

    assert nl.SOURCE == PKG / "csrc" / "vadio.cpp"
    path = nl.lib_path()
    assert path.parent == ROOT / "build" / "kernels"
    assert path.name.startswith("libvadio-") and path.suffix == ".so"
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [str(f) for f in files if "libvadio.so" in f.read_text()
           or re.search(r"[\"'/]native[\"'/]", f.read_text())]
    assert not bad, bad


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


@pytest.mark.parametrize("module,names", [
    ("score.scoring", ["BIG_NUMBER", "fuse_scores", "degenerate_boxes",
                       "frame_scores_from_cubes", "normalize_scores_per_video",
                       "splat_score_masks"]),
    ("eval.metrics", ["_binary_curve", "roc_curve", "precision_recall_curve", "auc",
                      "roc_auc_score", "EvalResult", "evaluate_scores",
                      "save_roc_pr_curve_data", "_PIXEL_DEVICE_CHUNK"]),
    ("ops.stc", ["pad_boxes"]),
    ("fore.detector", ["PrecomputedDetector"]),
    ("fore.mmdet_import", ["RESNET_STAGES", "BOTTLENECK_EXPANSION", "strip_checkpoint",
                           "infer_depth"]),
    ("fore.mmdet_detector", ["ANCHOR_RATIOS", "ANCHOR_SCALES", "ANCHOR_STRIDES",
                             "STAGE_STDS", "WH_RATIO_CLIP", "FINEST_SCALE",
                             "NUM_CLASSES", "base_anchors", "grid_anchors"]),
    ("fore.cascade_detector", ["STRIDES", "LEVEL_EDGES", "ROI_SIZE", "STAGE_IOUS",
                               "make_level_targets"]),
    ("runtime.artifacts", ["_flatten", "_unflatten", "save_pytree_npz",
                           "load_pytree_npz", "fingerprint", "ArtifactCache"]),
    ("runtime.profiling", ["StageTimer"]),
    ("models.completion_convert", ["_strip_module"]),
    ("train.grid_trainer", ["GridTrainer._uniform_has_flow"]),
    ("utils.meters", ["AverageMeter"]),
    ("utils.visualize", ["visualize_score", "tile_batch", "visualize_pair_map"]),
    ("utils.flowviz", ["UNKNOWN_FLOW_THRESH", "SMALL_FLOW", "LARGE_FLOW", "TAG_FLOAT",
                       "make_color_wheel", "compute_color", "flow_to_image", "read_flo",
                       "disp_to_flowfile", "segment_flow", "_hsv_to_rgb", "render_flow",
                       "visualize_flow", "show_flow", "scale_image", "flow_error"]),
    ("runtime.layer_profile", ["UNET_CONV_SHAPES", "FLAGSHIP_PER_CUBE_FWD_FLOPS",
                               "format_table"]),
    ("utils.blocks", ["calc_block_idx_batched"]),
    ("parallel.mesh", ["pad_to_multiple"]),
])
def test_copied_host_functions_equal_jax_package(module, names):
    """The host (NumPy) functions the main path copies are the JAX
    package's code, name for name."""
    import importlib
    import inspect
    import textwrap

    t_mod = importlib.import_module(f"vec_vad_torch.{module}")
    j_mod = importlib.import_module(f"vec_vad_tpu.{module}")
    for name in names:
        t_obj, j_obj = t_mod, j_mod
        for part in name.split("."):
            t_obj, j_obj = getattr(t_obj, part), getattr(j_obj, part)
        if not callable(t_obj):
            assert t_obj == j_obj, name
            continue
        assert ast.dump(ast.parse(textwrap.dedent(inspect.getsource(t_obj)))) == \
            ast.dump(ast.parse(textwrap.dedent(inspect.getsource(j_obj)))), name


@pytest.mark.parametrize("name", ["data/video_index.py", "data/readers.py"])
def test_data_modules_are_copies_of_jax_package(name):
    """video_index.py and readers.py are copies: the same code as the JAX
    package's, module docstrings aside, with the package renamed."""

    def code(path, pkg):
        tree = ast.parse(path.read_text().replace(pkg, "PKG"))
        assert isinstance(tree.body[0].value, ast.Constant)  # the docstring
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    assert code(PKG / name, "vec_vad_torch") == \
        code(ROOT / "vec_vad_tpu" / name, "vec_vad_tpu")


def test_kernel_sources_build_by_content():
    """Every csrc source has its own library name, keyed by its content,
    under the ignored build directory (nothing is built here)."""
    names = sorted(p.stem for p in (PKG / "csrc").glob("*.cu"))
    assert names == ["correlation", "correlation_bwd", "nms_scan"]
    for name in names:
        path = kernels._lib_path(name)
        assert path.parent == ROOT / "build" / "kernels"
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
