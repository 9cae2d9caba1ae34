"""Foreground boxes in the port against vec_vad_tpu on the same numpy
inputs from a seed: the motion maps bit for bit, the cv2-free contour
stage against the JAX package's cv2 one (content, order and dtype), the
suppression, patch modes and detection filter, `compute_foreground_bboxes`
in all four extraction modes, the `precompute-boxes` fixtures, `load_split`
without a fixture, and a mini precompute-boxes -> train -> test slice at
48x64, nf=4, patch 16."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_main_path import (
    DATASET,
    E2E_REL,
    _configs,
    _jax_init,
    _jax_trainer,
    _register,
    _rel,
    _write_workspace,
)
from vec_vad_torch import cli as t_cli
from vec_vad_torch import config as t_config
from vec_vad_torch import runner as t_runner
from vec_vad_torch.fore import detector as t_det
from vec_vad_torch.fore import motion as t_motion
from vec_vad_torch.fore import patches as t_patches
from vec_vad_torch.fore import suppress as t_suppress
from vec_vad_torch.train.trainer import BlockTrainer
from vec_vad_tpu import config as j_config
from vec_vad_tpu import runner as j_runner
from vec_vad_tpu.data.video_index import VideoIndex
from vec_vad_tpu.fore import detector as j_det
from vec_vad_tpu.fore import motion as j_motion
from vec_vad_tpu.fore import patches as j_patches
from vec_vad_tpu.fore import suppress as j_suppress

HW = (48, 64)
SPEC_KW = dict(name="fg", frame_h=HW[0], frame_w=HW[1], file_ext=".npy",
               scene_num=1, ap_score_thr=0.5, ap_min_area=16.0, cover_thr=0.6,
               mt_area_thr=16.0, mt_binary_thr=18.0, mt_extend=2,
               mt_gauss_mask_size=3)
LENGTHS = (12, 9, 2)  # the 2-frame video pins the hard windows' clamps


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _frames(lengths, h=HW[0], w=HW[1], seed=0):
    """Smooth frames with one moving block a video (real motion structure:
    pure noise would light the whole map) and a little noise."""
    r = np.random.default_rng(seed)
    vids = []
    for vi, n in enumerate(lengths):
        base = (100 + 40 * np.sin(np.arange(w) / 11.0 + vi)[None, :]
                + 20 * np.cos(np.arange(h) / 7.0)[:, None])
        frames = np.repeat(np.repeat(base[None, ..., None], n, 0), 3, -1)
        y0 = int(r.integers(4, h - 16))
        for t in range(n):
            x0 = (3 + 3 * t) % (w - 14)
            frames[t, y0:y0 + 12, x0:x0 + 10] += 90.0
        frames += r.integers(-3, 4, frames.shape)
        vids.append(np.clip(frames, 0, 255).astype(np.uint8))
    return np.concatenate(vids, axis=0)


def _assert_same_boxes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g, w)
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the dense stage: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,thr", [(3, 18), (5, 15), (7, 18)])
def test_motion_maps_equal_jax_bit_for_bit(k, thr):
    """Color windows of moving blocks over smooth and noisy content,
    gray (C=1) windows, and flat regions whose accumulated gradient
    200 + 60 wraps to 4 in uint8 (so stays below the threshold)."""
    rng = np.random.default_rng(k)
    f = _frames((6,), seed=k)
    color = np.stack([f[t:t + 3] for t in range(4)])  # (4, 3, H, W, 3)
    noisy = rng.integers(0, 256, (2, 3) + HW + (3,), dtype=np.uint8)
    gray = color[..., :1].copy()
    wrap = np.zeros((1, 3) + HW + (3,), np.uint8)
    wrap[0, 1] = 200
    wrap[0, 2] = 140
    wrap[0, 1, :, :20] = 0  # a band without wraparound beside it
    for win in (color, noisy, gray, wrap):
        want = np.asarray(j_motion.motion_maps(jnp.asarray(win), k, thr))
        got = t_motion.motion_maps(torch.from_numpy(win), k, thr)
        assert got.dtype == torch.bool and got.shape == win.shape[:1] + HW
        np.testing.assert_array_equal(got.numpy(), want)
    got = t_motion.motion_maps(torch.from_numpy(wrap), k, thr).numpy()[0]
    assert not got[HW[0] // 2, HW[1] // 2] and got[HW[0] // 2, 20]
    assert 0.01 < t_motion.motion_maps(torch.from_numpy(color), k, thr).float().mean() < 0.5


# ---------------------------------------------------------------------------
# the contour stage: cv2's boxes without cv2
# ---------------------------------------------------------------------------


def _blob_map(rng, h, w, n):
    """n random rectangles and crosses, some over the border."""
    m = np.zeros((h, w), bool)
    for _ in range(n):
        y, x = rng.integers(-3, h), rng.integers(-3, w)
        bh, bw = rng.integers(1, 12, 2)
        m[max(y, 0):max(y + bh, 0), max(x, 0):max(x + bw, 0)] = True
        if rng.random() < 0.3:
            m[max(y - 2, 0):max(y + bh + 2, 0), min(max(x + bw // 2, 0), w - 1)] = True
    return m


def _nested_map():
    """Rings with components in their holes (RETR_EXTERNAL drops those),
    a ring whose hole opens diagonally only (still a hole: the background
    is 4-connected), a blob touching two borders, and a diagonal chain."""
    m = np.zeros((40, 50), bool)
    m[2:20, 2:22] = True
    m[4:18, 4:20] = False
    m[8:12, 8:12] = True  # nested in the hole
    m[9:11, 14:16] = True  # another
    m[22:34, 24:40] = True
    m[24:32, 26:38] = False
    m[26:30, 29:33] = True
    m[29:31, 29:31] = False  # a hole inside the nested blob
    m[23, 24] = False  # a diagonal gap in the ring's corner
    m[0:6, 44:50] = True  # the top-right corner
    m[36:40, 0:9] = True  # the bottom border
    for i in range(6):
        m[20 + i, 42 + i] = True  # 8-connected diagonal
    return m


@pytest.mark.parametrize("kind", ["random", "blobs", "nested", "ap_masked"])
def test_motion_bboxes_equal_jax_cv2(kind):
    """The port's scipy route against the JAX package's cv2.findContours
    (RETR_EXTERNAL) + boundingRect: same boxes, same order, same dtype."""
    rng = np.random.default_rng(len(kind))
    cases = []
    if kind == "random":
        for _ in range(300):
            h, w = rng.integers(5, 61, 2)
            cases.append((rng.random((h, w)) < rng.uniform(0.05, 0.7), None, 5.0))
    elif kind == "blobs":
        for _ in range(200):
            h, w = rng.integers(8, 61, 2)
            cases.append((_blob_map(rng, h, w, rng.integers(1, 9)), None,
                          float(rng.integers(0, 40))))
    elif kind == "nested":
        m = _nested_map()
        cases = [(m, None, 0.0), (m, None, 30.0), (m.T.copy(), None, 4.0)]
    else:
        for _ in range(100):
            h, w = rng.integers(8, 61, 2)
            ap = rng.uniform(-6, max(h, w), (rng.integers(1, 4), 4))
            ap[:, 2:] += rng.uniform(0, 15, (ap.shape[0], 2)) + ap[:, :2]
            cases.append((_blob_map(rng, h, w, 6), ap.astype(np.float32), 4.0))
    n_found = 0
    for m, ap, area in cases:
        want = j_motion.motion_bboxes(m, ap, area, 2)
        got = t_motion.motion_bboxes(m, ap, area, 2)
        assert got.dtype == want.dtype and got.shape == want.shape, (got, want)
        np.testing.assert_array_equal(got, want)
        n_found += got.shape[0]
    assert n_found > 0
    if kind == "nested":  # 5 external components; the 3 nested are dropped
        assert t_motion.motion_bboxes(_nested_map(), None, 0.0, 0).shape[0] == 5


def test_suppress_patches_and_filter_equal_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 20):
        b = rng.uniform(0, 60, (n, 4))
        b[:, 2:] += b[:, :2] + rng.uniform(0, 30, (n, 2))
        s = rng.uniform(0, 1, n)
        for thr in (0.3, 0.6):
            np.testing.assert_array_equal(t_suppress.del_cover_bboxes(b, thr),
                                          j_suppress.del_cover_bboxes(b, thr))
        for sthr, area in ((0.5, 100.0), (0.25, 16.0)):
            got = t_det.filter_detections(b, s, sthr, area)
            np.testing.assert_array_equal(got,
                                          j_det.filter_detections(b, s, sthr, area))
    for hw in ((240, 360), (480, 856), (48, 64)):
        for hn, wn in ((3, 4), (6, 8), (1, 1)):
            np.testing.assert_array_equal(t_patches.get_patch_boxes(*hw, hn, wn),
                                          j_patches.get_patch_boxes(*hw, hn, wn))
        np.testing.assert_array_equal(t_patches.multi_scale_patch_boxes(*hw),
                                      j_patches.multi_scale_patch_boxes(*hw))
        np.testing.assert_array_equal(t_patches.full_frame_box(*hw),
                                      j_patches.full_frame_box(*hw))


# ---------------------------------------------------------------------------
# the split-level driver
# ---------------------------------------------------------------------------


def _detections(img):
    """A seeded stand-in detector: boxes and scores from the frame's sum."""
    r = np.random.default_rng(int(np.asarray(img, np.int64).sum()) % 2**32)
    n = int(r.integers(0, 6))
    b = r.uniform(0, 40, (n, 4))
    b[:, 2:] += b[:, :2] + r.uniform(2, 20, (n, 2))
    return b, r.uniform(0, 1, n)


class _Batched:
    """A detector with detect_many; records the batch shapes it was given."""

    def __init__(self):
        self.shapes = []

    def detect_many(self, imgs):
        self.shapes.append(np.shape(imgs))
        return [(*_detections(im), np.zeros(0)) for im in imgs]


@pytest.mark.parametrize("mode", ["simple_patch", "frame", "obj_det",
                                  "obj_det_with_motion"])
def test_compute_foreground_bboxes_equal_jax(mode):
    frames = _frames(LENGTHS, seed=5)
    idx = VideoIndex([f"v{i}" for i in range(len(LENGTHS))], np.asarray(LENGTHS))
    specs = [c.DatasetSpec(**SPEC_KW) for c in (j_config, t_config)]
    cfgs = [c.PipelineConfig(fore=c.ForegroundConfig(extraction_mode=mode))
            for c in (j_config, t_config)]
    for detector in (_detections, _Batched()):
        jd = detector if callable(detector) else _Batched()
        want = j_det.compute_foreground_bboxes(cfgs[0], specs[0], idx, frames=frames,
                                               detector=jd, chunk=5)
        got = t_det.compute_foreground_bboxes(cfgs[1], specs[1], idx, frames=frames,
                                              detector=detector, chunk=5,
                                              device="cpu")
        _assert_same_boxes(got, want)
        if not callable(detector) and mode.startswith("obj_det"):
            # batches of 4, the tail padded by repeating the last frame
            assert detector.shapes == jd.shapes == [(4,) + HW + (3,)] * 6
    if mode == "obj_det_with_motion":
        assert sum(b.shape[0] for b in got) > 30
        timings = {}
        again = t_det.compute_foreground_bboxes(
            cfgs[1], specs[1], idx, frames=frames, detector=lambda im: (
                np.zeros((0, 4)), np.zeros(0)), chunk=64, device="cpu",
            timings=timings)
        assert sorted(timings) == ["contours", "download", "maps", "read"]
        want = j_det.compute_foreground_bboxes(cfgs[0], specs[0], idx, frames=frames,
                                               detector=lambda im: (
                                                   np.zeros((0, 4)), np.zeros(0)))
        _assert_same_boxes(again, want)


def test_motion_path_runs_with_cv2_blocked():
    """The card's machine has no cv2: with cv2 (and JAX) blocked, the
    foreground driver and the motion scorer still run, and the motion
    module's source imports no cv2 at all."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(root, "vec_vad_torch", "fore", "motion.py")).read()
    assert not re.search(r"^\s*(import|from)\s+cv2\b", src, re.MULTILINE)
    code = (
        "import sys\n"
        "for m in ('cv2', 'jax', 'flax', 'optax', 'vec_vad_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from vec_vad_torch.config import DatasetSpec, PipelineConfig\n"
        "from vec_vad_torch.data.video_index import VideoIndex\n"
        "from vec_vad_torch.fore.detector import compute_foreground_bboxes\n"
        "f = np.full((6, 24, 32, 3), 90, np.uint8)\n"
        "for t in range(6):\n"
        "    f[t, 5:15, 2 + 3 * t:12 + 3 * t] = 200\n"
        f"spec = DatasetSpec(**{SPEC_KW!r})\n"
        "b = compute_foreground_bboxes(PipelineConfig(), spec, VideoIndex(['a'], "
        "np.array([6])), frames=f, detector=lambda i: (np.zeros((0, 4)), "
        "np.zeros(0)), device='cpu')\n"
        "assert sum(x.shape[0] for x in b) > 0, b\n"
        "assert 'cv2' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": root})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from vec_vad_torch.serve import MotionStreamingScorer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = t_config.DatasetSpec(**SPEC_KW)
    cfg = t_config.PipelineConfig()
    idx = VideoIndex(["a"], np.array([3]))
    frames = _frames((3,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_det.compute_foreground_bboxes(cfg, spec, idx, frames=frames,
                                        detector=_detections)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MotionStreamingScorer(cfg, {}, (0.0, 1.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["precompute-boxes", "--base", str(tmp_path),
                    "--dataset", "UCSDped2"])


# ---------------------------------------------------------------------------
# precompute-boxes, load_split without a fixture, and the mini slice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slice_ws(tmp_path_factory):
    """Both packages on their own copy of one workspace with its bbox
    fixtures removed: load_split's computed boxes, then precompute-boxes
    (JAX: run_precompute_boxes; the port: its CLI), then run_train and
    run_test from JAX's init_state(0)."""
    _register()
    jcfg, tcfg = _configs()
    bases, computed = {}, {}
    for name in ("jax", "torch"):
        base = str(tmp_path_factory.mktemp(f"fg_{name}"))
        _write_workspace(base)
        for split in ("train", "test"):
            os.remove(os.path.join(base, "raw_datasets", DATASET,
                                   f"bboxes_{split}_obj_det_with_motion.npy"))
        bases[name] = base
    computed["jax"] = j_runner.load_split(jcfg, bases["jax"], "test").boxes
    computed["torch"] = t_runner.load_split(tcfg, bases["torch"], "test",
                                            device="cpu").boxes
    j_runner.run_precompute_boxes(jcfg, bases["jax"])
    assert t_cli.main(["precompute-boxes", "--dataset", DATASET, "--base",
                       bases["torch"], "--device", "cpu"]) == 0
    _, _, params, stats = _jax_init(True, 0)
    mp = pytest.MonkeyPatch()
    mp.setattr(BlockTrainer, "init_state",
               lambda self, seed: self.state_from_variables(params, stats))
    mp.setattr(j_runner, "make_trainer", lambda cfg: _jax_trainer(True))
    try:
        jm, _ = j_runner.run_train(jcfg, bases["jax"])
        jres = j_runner.run_test(jcfg, bases["jax"], model=jm)
        tm, _ = t_runner.run_train(tcfg, bases["torch"], device="cpu")
        tres = t_runner.run_test(tcfg, bases["torch"], device="cpu")
    finally:
        mp.undo()
    return dict(bases=bases, computed=computed, jm=jm, tm=tm, jres=jres, tres=tres)


def test_precompute_boxes_cli_writes_jax_fixtures(slice_ws):
    for split in ("train", "test"):
        name = f"bboxes_{split}_obj_det_with_motion.npy"
        want, got = (np.load(os.path.join(slice_ws["bases"][k], "raw_datasets",
                                          DATASET, name), allow_pickle=True)
                     for k in ("jax", "torch"))
        assert got.dtype == want.dtype == object and len(got) == len(want) == 38
        _assert_same_boxes(list(got), list(want))
        assert all(b.dtype == np.float32 for b in got)
        assert sum(b.shape[0] for b in got) > 38


def test_load_split_without_fixture_equals_jax(slice_ws):
    got, want = slice_ws["computed"]["torch"], slice_ws["computed"]["jax"]
    _assert_same_boxes(got, want)
    fixture = np.load(os.path.join(slice_ws["bases"]["torch"], "raw_datasets",
                                   DATASET, "bboxes_test_obj_det_with_motion.npy"),
                      allow_pickle=True)
    _assert_same_boxes([np.asarray(b, np.float32) for b in got], list(fixture))


def test_precompute_train_test_mini_slice_matches_jax(slice_ws):
    """run_train -> run_test on the computed boxes, port against JAX from
    the same initial weights: the main path's bound (E2E_REL, 5e-4 of the
    largest) on the training scores and the frame scores."""
    w = slice_ws
    tb, jb = w["tm"].blocks[(0, 0, 0)], w["jm"].blocks[(0, 0, 0)]
    assert tb.raw_scores.shape == jb.raw_scores.shape
    assert _rel(tb.raw_scores, jb.raw_scores) <= E2E_REL
    tf, jf = w["tres"]["frame_scores"], w["jres"]["frame_scores"]
    assert tf.shape == jf.shape == (38,) and np.isfinite(tf).all()
    assert _rel(tf, jf) <= E2E_REL, _rel(tf, jf)
    assert abs(w["tres"]["auroc"] - w["jres"]["auroc"]) <= 0.02
