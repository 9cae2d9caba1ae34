"""The port's tooling held against cv2 and vec_vad_tpu: the native frame
decoder (csrc/vadio.cpp, built here by g++) bit for bit with cv2.imread,
its pool, prefetcher, header probe and refusals, the runner reading .jpg
trees through it, the cv2-free PNG codec and colour helpers, the
visualize/flowviz/gradtap/meters ports, and the `visualize` and
`extract-frames` CLIs.

Bounds: decoded frames, written images and uint8 renderings equal; float
renderings 1e-6; warp_image_np 1e-5 (the same f32 arithmetic in another
order); GradTaps 1e-6. The one departure is `_to_u8` on near-black uint8
frames (ROADMAP.md Queue 3), which a test shows."""

import dataclasses
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import vec_vad_torch.runner as t_runner
from vec_vad_torch import cli as t_cli
from vec_vad_torch import config as t_cfg
from vec_vad_torch.data.readers import LazyFrameStack
from vec_vad_torch.data.video_index import VideoIndex
from vec_vad_torch.runtime import native_loader as nl
from vec_vad_torch.utils import flowviz as t_fv
from vec_vad_torch.utils import gradtap as t_gt
from vec_vad_torch.utils import meters as t_meters
from vec_vad_torch.utils import png as t_png
from vec_vad_torch.utils import visualize as t_vis
from vec_vad_tpu.utils import flowviz as j_fv
from vec_vad_tpu.utils import gradtap as j_gt
from vec_vad_tpu.utils import meters as j_meters
from vec_vad_tpu.utils import visualize as j_vis

FIXTURES = Path(__file__).resolve().parent / "data" / "frames"
HW = (24, 32)


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fixture_paths():
    return sorted(p for p in FIXTURES.iterdir() if p.suffix in (".jpg", ".png", ".tif"))


# -- the native decoder ------------------------------------------------------


def test_decoder_equals_cv2_on_the_fixtures():
    """Every committed frame (3 jpg at 360x640, gray and colour png and tif
    at 240x360) decodes to cv2.imread's array bit for bit, and to the
    arrays cv2 stored in decoded.npz when it wrote them."""
    paths = _fixture_paths()
    assert sorted({p.suffix for p in paths}) == [".jpg", ".png", ".tif"]
    stored = np.load(FIXTURES / "decoded.npz")
    assert sorted(stored.files) == sorted(p.name for p in paths)
    pool = nl.NativePool(2)
    for p in paths:
        want = cv2.imread(str(p))
        h, w = want.shape[:2]
        assert nl.probe_image(str(p))[:2] == (h, w)
        got = pool.decode_batch([str(p)], h, w)[0]
        np.testing.assert_array_equal(got, want, err_msg=p.name)
        np.testing.assert_array_equal(got, stored[p.name], err_msg=p.name)


@pytest.mark.parametrize("ext", [".jpg", ".png", ".tif"])
def test_decoder_equals_cv2_on_seeded_images(tmp_path, ext):
    """Seeded colour and gray images of odd sizes written by cv2: the
    single-file decode, the pool and the header probe agree with cv2."""
    rng = np.random.default_rng(3)
    lib = nl.get_lib()
    for i, shape in enumerate([(37, 53, 3), (40, 61), (16, 16, 3)]):
        img = cv2.GaussianBlur(rng.integers(0, 256, shape, dtype=np.uint8), (3, 3), 0)
        path = str(tmp_path / f"{i}{ext}")
        assert cv2.imwrite(path, img)
        want = cv2.imread(path)
        h, w = want.shape[:2]
        out = np.empty((h, w, 3), np.uint8)
        assert lib.vadio_decode(os.fsencode(path), out.ctypes.data, h, w) == 0
        np.testing.assert_array_equal(out, want)
        channels = 1 if len(shape) == 2 else 3
        assert nl.probe_image(path) == (h, w, channels, 8)


def test_pool_prefetcher_and_refusals(tmp_path):
    """The pool fills one (N, H, W, 3) batch in order, the prefetcher
    yields the same frames in chunks (the last one short), and a corrupt
    file, a missing file or a frame of another size is refused."""
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, HW + (3,), dtype=np.uint8) for _ in range(7)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"{i:02d}.png"))
        cv2.imwrite(paths[-1], img)
    batch = nl.NativePool(3).decode_batch(paths, *HW)
    np.testing.assert_array_equal(batch, np.stack(imgs))
    chunks = list(nl.NativePrefetcher(paths, 3, *HW, n_threads=2))
    assert [len(c) for c in chunks] == [3, 3, 1]
    np.testing.assert_array_equal(np.concatenate(chunks), np.stack(imgs))

    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0 not a jpeg at all")
    with pytest.raises(IOError, match="1/2 frames failed"):
        nl.NativePool(2).decode_batch([paths[0], str(bad)], *HW)
    with pytest.raises(IOError, match="header probe failed"):
        nl.probe_image(str(bad))
    with pytest.raises(IOError, match="header probe failed"):
        nl.probe_image(str(tmp_path / "missing.png"))
    big = tmp_path / "big.png"
    cv2.imwrite(str(big), np.zeros((30, 40, 3), np.uint8))
    with pytest.raises(IOError, match="failed native decode"):
        nl.NativePool(1).decode_batch([str(big)], *HW)
    with pytest.raises(IOError, match="failed native decode"):
        list(nl.NativePrefetcher([paths[0], str(bad)], 2, *HW))


def test_make_frame_stack_routes_by_extension(tmp_path):
    """.jpg/.png/.tif trees get the native stack (shape from the header
    probe, frames as cv2 reads them); .npy trees and prefer_native=False
    get LazyFrameStack."""
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (4,) + HW + (3,), dtype=np.uint8)
    for ext in (".jpg", ".tif", ".npy"):
        paths = [str(tmp_path / f"{i}{ext}") for i in range(4)]
        for p, f in zip(paths, frames):
            np.save(p, f) if ext == ".npy" else cv2.imwrite(p, f)
        index = VideoIndex(["v"], [4], paths)
        stack = nl.make_frame_stack(index)
        want = LazyFrameStack(index)
        if ext == ".npy":
            assert type(stack) is LazyFrameStack
            continue
        assert isinstance(stack, nl.NativeFrameStack) and stack.shape == want.shape
        np.testing.assert_array_equal(np.asarray(stack), np.asarray(want))
        np.testing.assert_array_equal(stack[2], want[2])
        np.testing.assert_array_equal(stack[[3, 1]], want[[3, 1]])
        np.testing.assert_array_equal(stack[1:3], want[1:3])
        assert type(nl.make_frame_stack(index, prefer_native=False)) is LazyFrameStack


def test_build_failure_raises_with_its_log(tmp_path, monkeypatch):
    """A decoder that does not build raises NativeBuildError carrying the
    compiler's output; make_frame_stack does not fall back to cv2. The
    library's name follows its source, so the edited source builds anew."""
    broken = tmp_path / "vadio.cpp"
    broken.write_text((nl.SOURCE.read_text()) + "\nthis does not compile;\n")
    good = nl.lib_path()
    monkeypatch.setattr(nl, "SOURCE", broken)
    monkeypatch.setattr(nl, "_LIB", None)
    assert nl.lib_path() != good and nl.lib_path().parent == good.parent
    assert nl.get_lib(auto_build=False) is None
    path = str(tmp_path / "0.jpg")
    cv2.imwrite(path, np.zeros(HW + (3,), np.uint8))
    with pytest.raises(nl.NativeBuildError, match="this does not compile"):
        nl.make_frame_stack(VideoIndex(["v"], [1], [path]))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(nl.NativeBuildError, match="no-such-compiler"):
        nl.build_native()
    assert not nl.lib_path().exists()

    # a library that exists but does not load (built where libjpeg is,
    # copied where it is not) raises the same way
    other = tmp_path / "vadio_other.cpp"
    other.write_text(nl.SOURCE.read_text() + "\n// another build\n")
    monkeypatch.setattr(nl, "SOURCE", other)
    stale = nl.lib_path()
    stale.write_bytes(b"not a shared object")
    try:
        with pytest.raises(nl.NativeBuildError, match="does not load"):
            nl.get_lib()
    finally:
        stale.unlink()


def _write_avenue_tree(base, frames_by_split, ext):
    """avenue's layout (training/frames/NN, testing/frames/NN) with the
    given frames, bbox fixtures of one box a frame."""
    root = os.path.join(base, "raw_datasets", "avenue")
    for split, videos in frames_by_split.items():
        sub = "training" if split == "train" else "testing"
        boxes = []
        for v, vid in enumerate(videos):
            d = os.path.join(root, sub, "frames", f"{v + 1:02d}")
            os.makedirs(d)
            for t, f in enumerate(vid):
                p = os.path.join(d, f"{t:04d}{ext}")
                np.save(p, f) if ext == ".npy" else cv2.imwrite(p, f)
                boxes.append(np.array([[2, 2, 14, 14]], np.float32))
        arr = np.empty(len(boxes), object)
        arr[:] = boxes
        np.save(os.path.join(root, f"bboxes_{split}_obj_det_with_motion.npy"), arr,
                allow_pickle=True)


def test_runner_reads_jpg_trees_natively(tmp_path, monkeypatch):
    """load_split and run_calc_flow on a tiny avenue .jpg tree against the
    same frames as a .npy tree (cv2's decode of each jpg): the jpg split's
    frames come from the native stack and equal the .npy ones, and the
    flow trees are equal (a tiny flow net stands in for FlowNet2, as in
    tests/test_torch_calc_flow.py). run_precompute_boxes reads through
    make_frame_stack too."""
    from test_torch_serving import TinyFlow, TorchTinyFlow

    rng = np.random.default_rng(6)
    videos = {s: [cv2.GaussianBlur(rng.integers(0, 256, (n,) + HW + (3,), dtype=np.uint8)
                                   .reshape(-1, HW[1], 3), (3, 3), 0).reshape((n,) + HW + (3,))
                  for n in lens] for s, lens in (("train", (4, 3)), ("test", (3,)))}
    jpg, npy = str(tmp_path / "jpg"), str(tmp_path / "npy")
    _write_avenue_tree(jpg, videos, ".jpg")
    decoded = {s: [np.stack([cv2.imread(os.path.join(
        jpg, "raw_datasets", "avenue", "training" if s == "train" else "testing",
        "frames", f"{v + 1:02d}", f"{t:04d}.jpg")) for t in range(len(vid))])
        for v, vid in enumerate(vids)] for s, vids in videos.items()}
    _write_avenue_tree(npy, decoded, ".npy")

    x0 = jnp.zeros((1, 2, 16, 24, 3))
    twin = TorchTinyFlow(TinyFlow().init(jax.random.key(0), x0))
    monkeypatch.setattr(t_runner, "make_flownet2", lambda seed, device: twin)
    made = []
    real = t_runner.make_frame_stack
    monkeypatch.setattr(t_runner, "make_frame_stack",
                        lambda index: made.append(real(index)) or made[-1])
    spec = t_cfg.DATASETS["avenue"]
    cfg = t_cfg.PipelineConfig(dataset_name="avenue")
    trees = {}
    for base, ext in ((jpg, ".jpg"), (npy, ".npy")):
        monkeypatch.setitem(t_cfg.DATASETS, "avenue", dataclasses.replace(spec, file_ext=ext))
        for split in ("train", "test"):
            data = t_runner.load_split(cfg, base, split, device="cpu")
            assert isinstance(data.frames, nl.NativeFrameStack) == (ext == ".jpg")
            np.testing.assert_array_equal(np.asarray(data.frames),
                                          np.concatenate(decoded[split]))
        made.clear()
        t_runner.run_calc_flow(cfg, base, device="cpu")
        assert [type(m) for m in made] == [type(data.frames)] * 2
        trees[ext] = {}
        of_root = os.path.join(base, "optical_flow", "avenue")
        for d, _, files in os.walk(of_root):
            for f in files:
                trees[ext][os.path.relpath(os.path.join(d, f), of_root)] = \
                    np.load(os.path.join(d, f))
    assert len(trees[".jpg"]) == 10 and sorted(trees[".jpg"]) == sorted(trees[".npy"])
    for rel, want in trees[".npy"].items():
        np.testing.assert_array_equal(trees[".jpg"][rel], want, err_msg=rel)

    monkeypatch.setitem(t_cfg.DATASETS, "avenue", spec)
    made.clear()
    t_runner.run_precompute_boxes(cfg, jpg, splits=("test",), overwrite=True,
                                  device="cpu")
    assert len(made) == 1 and isinstance(made[0], nl.NativeFrameStack)


# -- the PNG codec and cv2's colour helpers ----------------------------------


@pytest.mark.parametrize("kind", ["gray8", "bgr8", "bgr16"])
def test_png_codec_against_cv2_both_ways(tmp_path, kind):
    """write_png's files read back by cv2.imread(IMREAD_UNCHANGED) equal
    the image, and read_png reads cv2.imwrite's files equal to it."""
    rng = np.random.default_rng(7)
    shape, dtype = {"gray8": ((29, 41), np.uint8), "bgr8": ((29, 41, 3), np.uint8),
                    "bgr16": ((29, 41, 3), np.uint16)}[kind]
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "cv2.png")
    t_png.write_png(ours, img)
    back = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    assert back.dtype == dtype and back.shape == shape
    np.testing.assert_array_equal(back, img)
    cv2.imwrite(theirs, img)
    got = t_png.read_png(theirs)
    assert got.dtype == dtype and got.shape == shape
    np.testing.assert_array_equal(got, img)
    with pytest.raises(ValueError):
        t_png.encode_png(img.astype(np.float32))


def test_png_reader_keeps_alpha_and_16_bit_gray(tmp_path):
    """read_png keeps what IMREAD_UNCHANGED keeps: BGRA and 16-bit gray."""
    rng = np.random.default_rng(8)
    for img in (rng.integers(0, 256, (9, 13, 4), dtype=np.uint8),
                rng.integers(0, 65536, (9, 13), dtype=np.uint16)):
        p = str(tmp_path / f"{img.ndim}.png")
        cv2.imwrite(p, img)
        np.testing.assert_array_equal(t_png.read_png(p), cv2.imread(p, cv2.IMREAD_UNCHANGED))


def test_colour_helpers_equal_cv2():
    """JET on all 256 levels, addWeighted at several alphas (uint8, with a
    gamma), and nearest resizes up and down equal cv2's."""
    levels = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        t_vis.apply_jet(levels), cv2.applyColorMap(levels[:, None], cv2.COLORMAP_JET)[:, 0])
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (61, 83, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (61, 83, 3), dtype=np.uint8)
    for alpha in (0.5, 0.3, 0.7, 0.1, 0.37, 1 / 3):
        np.testing.assert_array_equal(
            t_vis.add_weighted(a, 1 - alpha, b, alpha),
            cv2.addWeighted(a, 1 - alpha, b, alpha, 0.0), err_msg=str(alpha))
    np.testing.assert_array_equal(t_vis.add_weighted(a, 0.6, b, 0.6, 7.0),
                                  cv2.addWeighted(a, 0.6, b, 0.6, 7.0))
    for src, dst in (((15, 22), (240, 360)), ((240, 360), (48, 64)),
                     ((30, 45), (29, 44)), ((7, 9), (100, 3)), ((48, 64), (480, 856))):
        img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
        np.testing.assert_array_equal(
            t_vis.resize_nearest(img, dst),
            cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST), err_msg=str(dst))


# -- visualize.py and flowviz.py against vec_vad_tpu --------------------------


def _masks(rng, n, hw):
    m = rng.normal(size=(n,) + hw) * 3.0
    m[:, : hw[0] // 3] = -1e5  # uncovered rows
    m[0] = -1e5  # nothing covered
    return m


def test_visualize_functions_equal_jax():
    """visualize_score, tile_batch, error_heatmap, visualize_pair_map and
    score_mask_overlay (gray and BGR frames, the mask resized, two alphas)
    equal vec_vad_tpu's on seeded inputs."""
    rng = np.random.default_rng(10)
    masks = _masks(rng, 3, (12, 16))
    for m in masks:
        np.testing.assert_array_equal(t_vis.visualize_score(m), j_vis.visualize_score(m))
    batch = rng.integers(0, 256, (5, 6, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(t_vis.tile_batch(batch, 2), j_vis.tile_batch(batch, 2))
    a, b = rng.uniform(0, 1, (2, 5, 6, 7, 3))
    np.testing.assert_array_equal(t_vis.error_heatmap(a[0], b[0]),
                                  j_vis.error_heatmap(a[0], b[0]))
    for got, want in zip(t_vis.visualize_pair_map(a, b, 3), j_vis.visualize_pair_map(a, b, 3)):
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    frame = rng.integers(20, 256, (24, 32, 3), dtype=np.uint8)
    for f in (frame, frame[:, :, 0]):
        for m in masks[1:]:
            for alpha in (0.5, 0.3):
                np.testing.assert_array_equal(
                    t_vis.score_mask_overlay(f, m, alpha=alpha),
                    j_vis.score_mask_overlay(f, m, alpha=alpha))
    m = rng.normal(size=(24, 32))
    np.testing.assert_array_equal(t_vis.score_mask_overlay(frame, m),
                                  j_vis.score_mask_overlay(frame, m))


def test_to_u8_departs_on_near_black_uint8_frames():
    """The port scales only float input by 255: a uint8 frame whose
    maximum is 1 stays near black, where vec_vad_tpu's _to_u8 turns it
    white. Float input and brighter uint8 frames are scaled alike."""
    dark = np.random.default_rng(11).integers(0, 2, (6, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(t_vis._to_u8(dark), dark)
    np.testing.assert_array_equal(j_vis._to_u8(dark), dark * 255)
    m = np.zeros((6, 8))
    # a constant mask renders JET's level 0, (128, 0, 0), blended half and half
    assert t_vis.score_mask_overlay(dark, m).max() <= 65
    assert j_vis.score_mask_overlay(dark, m).max() == 192
    for x in (np.linspace(0, 1, 48).reshape(6, 8), np.full((6, 8), 200, np.uint8)):
        np.testing.assert_array_equal(t_vis._to_u8(x), j_vis._to_u8(x))


def test_flowviz_functions_equal_jax(tmp_path):
    """Colour wheel, compute_color, flow_to_image (with unknown flow),
    segment_flow, _hsv_to_rgb, render_flow in both modes, scale_image,
    flow_error, visualize_flow / show_flow without a display, and the
    KITTI / disparity png IO across the two packages' files."""
    rng = np.random.default_rng(12)
    np.testing.assert_array_equal(t_fv.make_color_wheel(), j_fv.make_color_wheel())
    flow = rng.normal(size=(20, 28, 2)) * 4.0
    flow[0, 0] = [2e7, 0.0]
    flow[1, :4] = 0.0
    flow[2, 1] = [0.0, 3.0]
    u, v = rng.normal(size=(2, 20, 28)) * 0.5
    u[0, 0] = np.nan
    np.testing.assert_array_equal(t_fv.compute_color(u, v), j_fv.compute_color(u, v))
    np.testing.assert_array_equal(t_fv.flow_to_image(flow), j_fv.flow_to_image(flow))
    np.testing.assert_array_equal(t_fv.flow_to_image(flow, 3.0), j_fv.flow_to_image(flow, 3.0))
    np.testing.assert_array_equal(t_fv.segment_flow(flow), j_fv.segment_flow(flow))
    hsv = rng.uniform(0, 1, (9, 11, 3))
    np.testing.assert_allclose(t_fv._hsv_to_rgb(hsv), j_fv._hsv_to_rgb(hsv), rtol=0, atol=1e-6)
    flow3 = np.dstack([flow, rng.integers(0, 2, (20, 28))]).astype(np.float64)
    np.testing.assert_array_equal(t_fv.render_flow(flow, "Y"), j_fv.render_flow(flow, "Y"))
    np.testing.assert_allclose(t_fv.render_flow(flow3, "RGB"), j_fv.render_flow(flow3, "RGB"),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        t_fv.render_flow(flow, "HSV")
    img = rng.normal(size=(7, 9))
    np.testing.assert_array_equal(t_fv.scale_image(img, (0, 255)), j_fv.scale_image(img, (0, 255)))
    tu, tv = rng.normal(size=(2, 10, 10))
    tu[0, 0] = 1e8
    assert abs(t_fv.flow_error(tu, tv, u[:10, :10], v[:10, :10])
               - j_fv.flow_error(tu, tv, u[:10, :10], v[:10, :10])) <= 1e-12
    np.testing.assert_array_equal(t_fv.visualize_flow(flow, show=False),
                                  j_fv.visualize_flow(flow, show=False))
    t_fv.write_flo(str(tmp_path / "f.flo"), flow.astype(np.float32))
    np.testing.assert_array_equal(t_fv.show_flow(str(tmp_path / "f.flo"), show=False),
                                  j_fv.show_flow(str(tmp_path / "f.flo"), show=False))

    kitti = np.dstack([flow, np.ones((20, 28))])
    t_fv.write_kitti_png(str(tmp_path / "t.png"), kitti)
    j_fv.write_kitti_png(str(tmp_path / "j.png"), kitti)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t.png"), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED))
    for name in ("t.png", "j.png"):
        np.testing.assert_array_equal(t_fv.read_kitti_png(str(tmp_path / name)),
                                      j_fv.read_kitti_png(str(tmp_path / name)))
    disp = rng.integers(0, 65536, (20, 28, 3), dtype=np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), disp)
    cv2.imwrite(str(tmp_path / "d1.png"), disp[:, :, 0])
    for name in ("d.png", "d1.png"):
        np.testing.assert_array_equal(t_fv.read_disp_png(str(tmp_path / name)),
                                      j_fv.read_disp_png(str(tmp_path / name)))
    d = t_fv.read_disp_png(str(tmp_path / "d.png"))
    t_fv.disp_to_flowfile(d, str(tmp_path / "t.flo"))
    j_fv.disp_to_flowfile(d, str(tmp_path / "j.flo"))
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()


def test_warp_image_np_matches_jax():
    """warp_image_np on the CPU against vec_vad_tpu's (JAX's warp), 1e-5,
    and on the card by default."""
    rng = np.random.default_rng(13)
    img = rng.uniform(0, 255, (18, 22, 3))
    flow = rng.normal(size=(18, 22, 2)) * 3.0
    got = t_fv.warp_image_np(img, flow, device="cpu")
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_allclose(got, j_fv.warp_image_np(img, flow), rtol=0, atol=1e-5)


def test_grad_taps_match_jax():
    """A tap on an intermediate of the same small function stores the same
    gradient as vec_vad_tpu's GradTaps (1e-6), passes the gradient on
    unchanged, and is the identity forward."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=(4, 5)).astype(np.float32)
    w = rng.normal(size=(5, 3)).astype(np.float32)

    jt = j_gt.GradTaps()

    def jf(x, w):
        h = jt.tap("h", jnp.tanh(x @ w))
        return jnp.sum(jt.tap("sq", h * h) * jnp.arange(3.0))

    jgrad = jax.grad(jf, argnums=1)(jnp.asarray(x), jnp.asarray(w))

    tt = t_gt.GradTaps()
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(w).requires_grad_(True)
    h = tt.tap("h", torch.tanh(xt @ wt))
    assert torch.equal(h, torch.tanh(xt @ wt))
    loss = torch.sum(tt.tap("sq", h * h) * torch.arange(3.0))
    loss.backward()
    assert sorted(tt.grads) == sorted(jt.grads) == ["h", "sq"]
    for name in ("h", "sq"):
        assert isinstance(tt.grads[name], np.ndarray)
        np.testing.assert_allclose(tt.grads[name], jt.grads[name], rtol=0, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-6)


def test_average_meter_equals_jax():
    t, j = t_meters.AverageMeter(), j_meters.AverageMeter()
    for val, n in ((2.0, 1), (4.0, 3), (0.5, 2)):
        t.update(val, n)
        j.update(val, n)
        assert (t.val, t.sum, t.count, t.avg) == (j.val, j.sum, j.count, j.avg)
    assert t.avg == pytest.approx((2.0 + 12.0 + 1.0) / 6)
    t.reset()
    assert (t.val, t.avg, t.sum, t.count) == (0.0, 0.0, 0.0, 0)


# -- the CLIs ----------------------------------------------------------------


def test_visualize_cli(tmp_path, monkeypatch):
    """`visualize` with --frames-root (frames 1..11.jpg, whose
    lexicographic order differs from their natural one), with --config
    (the avenue test split through the native stack) and with --flow-dir
    (.npy and .flo): the PNGs it writes read back equal to what
    visualize_score, score_mask_overlay and flow_to_image return; a frame
    count other than the masks' is refused."""
    rng = np.random.default_rng(15)
    n = 11
    frames = rng.integers(0, 256, (n,) + HW + (3,), dtype=np.uint8)
    masks = rng.normal(size=(n, 12, 16))
    masks[:, :3] = -1e5
    np.save(tmp_path / "masks.npy", masks)
    root = tmp_path / "frames"
    root.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(root / f"{i + 1}.png"), f)
    flows = tmp_path / "flow" / "01"
    flows.mkdir(parents=True)
    flow = rng.normal(size=HW + (2,)).astype(np.float32)
    np.save(flows / "0000.npy", flow)
    t_fv.write_flo(str(flows / "0001.flo"), -flow)

    out = tmp_path / "out"
    assert t_cli.main(["visualize", "--masks", str(tmp_path / "masks.npy"),
                       "--frames-root", str(root), "--flow-dir",
                       str(tmp_path / "flow"), "--out", str(out)]) == 0
    assert len(list(out.glob("*.png"))) == 2 * n + 2
    for i in (0, 9, 10):
        np.testing.assert_array_equal(t_png.read_png(str(out / f"score_{i:06d}.png")),
                                      t_vis.visualize_score(masks[i]))
        np.testing.assert_array_equal(t_png.read_png(str(out / f"overlay_{i:06d}.png")),
                                      t_vis.score_mask_overlay(frames[i], masks[i]))
    np.testing.assert_array_equal(t_png.read_png(str(out / "flow_01_0000.npy.png")),
                                  t_fv.flow_to_image(flow)[:, :, ::-1])
    np.testing.assert_array_equal(t_png.read_png(str(out / "flow_01_0001.flo.png")),
                                  t_fv.flow_to_image(-flow)[:, :, ::-1])

    cv2.imwrite(str(root / "extra.png"), frames[0])
    with pytest.raises(ValueError, match="12 frames for 11 score masks"):
        t_cli.main(["visualize", "--masks", str(tmp_path / "masks.npy"),
                    "--frames-root", str(root), "--out", str(out)])

    base = tmp_path / "ws"
    _write_avenue_tree(str(base), {"train": [frames[:4]], "test": [frames[:6], frames[6:]]},
                       ".jpg")
    (tmp_path / "c.cfg").write_text("[shared_parameters]\ndataset_name = avenue\n")
    out2 = tmp_path / "out2"
    assert t_cli.main(["visualize", "--masks", str(tmp_path / "masks.npy"),
                       "--config", str(tmp_path / "c.cfg"), "--base", str(base),
                       "--limit", "8", "--out", str(out2), "--alpha", "0.3"]) == 0
    assert len(list(out2.glob("*.png"))) == 16
    test_frames = np.asarray(t_runner.load_split(
        t_cfg.PipelineConfig(dataset_name="avenue"), str(base), "test", device="cpu").frames)
    for i in (0, 7):
        np.testing.assert_array_equal(
            t_png.read_png(str(out2 / f"overlay_{i:06d}.png")),
            t_vis.score_mask_overlay(test_frames[i], masks[i], alpha=0.3))
    with pytest.raises(SystemExit):
        t_cli.main(["visualize", "--masks", str(tmp_path / "masks.npy"), "--config",
                    str(tmp_path / "c.cfg"), "--frames-root", str(root), "--out", str(out)])
    assert t_cli.main(["visualize", "--out", str(out)]) == 2


def test_extract_frames_cli(tmp_path, monkeypatch):
    """`extract-frames` on a tiny video cv2 wrote: one %06d.jpg a frame,
    as cv2 decodes them; without cv2 it raises an ImportError that names
    the missing video decoder."""
    video = str(tmp_path / "v.avi")
    wr = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 24))
    assert wr.isOpened()
    rng = np.random.default_rng(16)
    for _ in range(5):
        wr.write(rng.integers(0, 256, HW + (3,), dtype=np.uint8))
    wr.release()
    out = tmp_path / "frames"
    assert t_cli.main(["extract-frames", "--video", video, "--out", str(out)]) == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == [f"{i:06d}.jpg" for i in range(1, 6)]
    cap = cv2.VideoCapture(video)
    ok, first = cap.read()
    cap.release()
    assert ok
    np.testing.assert_array_equal(cv2.imread(str(out / "000001.jpg")),
                                  cv2.imdecode(cv2.imencode(".jpg", first)[1], cv2.IMREAD_COLOR))
    assert t_cli.main(["extract-frames", "--video", str(tmp_path / "none.avi"),
                       "--out", str(out)]) == 1
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="video decoder"):
        t_cli.main(["extract-frames", "--video", video, "--out", str(out)])
