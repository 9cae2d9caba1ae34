"""calc-flow, the offline flow tree: the port's video index, frame readers,
flow driver, runner and CLI held against vec_vad_tpu on the same inputs.

The flow net is the small stand-in of tests/test_torch_serving.py
(TinyFlow, twinned in torch with its flax weights); FlowNet2's own parity
is tests/test_torch_flownet.py's. The flow bound is atol 1e-5, the JAX
driver tests' own (tests/test_flow_driver.py): the same float32 resize and
convolutions summed in other orders."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import vec_vad_torch.runner as t_runner
import vec_vad_tpu.models.flownet as j_flownet
import vec_vad_tpu.runner as j_runner
from test_torch_serving import TinyFlow, TorchTinyFlow
from vec_vad_torch import cli as t_cli
from vec_vad_torch import config as t_cfg
from vec_vad_torch.data import readers as t_readers
from vec_vad_torch.data import video_index as t_vi
from vec_vad_torch.flow import driver as t_driver
from vec_vad_tpu import config as j_cfg
from vec_vad_tpu.data import readers as j_readers
from vec_vad_tpu.data import video_index as j_vi
from vec_vad_tpu.flow import driver as j_driver

HW = (24, 32)  # tiny frames
MODEL_HW = (16, 24)  # tiny stand-in for the 384x512 protocol
ATOL = 1e-5
DATASET = "tinyflow"


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def flow_nets():
    net = TinyFlow()
    v = net.init(jax.random.key(3), jnp.zeros((1, 2) + MODEL_HW + (3,)))
    return net, v, TorchTinyFlow(v)


def _frames(n, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n,) + HW + (channels,), dtype=np.uint8)


def _write_ucsd_tree(root, lengths, seed=0, ext=".npy"):
    """A UCSD-layout tree (Train/TrainNNN, Test/TestNNN plus a *_gt dir)
    of seeded uint8 .npy frames; lengths = {"Train": [...], "Test": [...]}."""
    rng = np.random.default_rng(seed)
    for split, lens in lengths.items():
        for v, ln in enumerate(lens):
            d = os.path.join(root, split, f"{split}{v + 1:03d}")
            os.makedirs(d)
            for t in range(ln):
                np.save(os.path.join(d, f"{t:03d}{ext}"),
                        rng.integers(0, 256, HW + (3,), dtype=np.uint8))
    os.makedirs(os.path.join(root, "Test", "Test001_gt"))


# -- video index -------------------------------------------------------------


@pytest.mark.parametrize("mode", ["elastic", "predict", "hard"])
def test_context_indices_match_jax(mode):
    """All three border modes over ragged video lengths: equal windows,
    or the same VideoTooShortError."""
    cases = [[5, 3, 9], [2, 7], [1, 6, 4], [12], [3, 3, 3, 1], [4, 1]]
    raised = 0
    for lengths in cases:
        v = np.repeat(np.arange(1, len(lengths) + 1), lengths)
        for ctx in (0, 1, 2, 4):
            try:
                want = j_vi.context_indices(v, ctx, mode)
            except j_vi.VideoTooShortError:
                with pytest.raises(t_vi.VideoTooShortError):
                    t_vi.context_indices(v, ctx, mode)
                raised += 1
                continue
            got = t_vi.context_indices(v, ctx, mode)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert raised > 0  # the too-short branches ran
    with pytest.raises(NotImplementedError):
        t_vi.context_indices(np.ones(4, np.int64), 1, "wrap")


def _touch_frames(vdir, n, ext):
    os.makedirs(vdir)
    for t in range(n):
        open(os.path.join(vdir, f"{t:04d}{ext}"), "w").close()


@pytest.mark.parametrize("dataset", ["UCSDped2", "avenue", "ShanghaiTech"])
def test_video_index_from_layout_matches_jax(tmp_path, dataset):
    """Each dataset's directory convention: equal names, lengths, paths,
    per-frame video and scene indices, for both splits."""
    root = str(tmp_path)
    if dataset == "UCSDped2":
        for v, n in enumerate((4, 3)):
            _touch_frames(os.path.join(root, "Train", f"Train{v + 1:03d}"), n, ".tif")
        for v, n in enumerate((5, 2)):
            _touch_frames(os.path.join(root, "Test", f"Test{v + 1:03d}"), n, ".tif")
        _touch_frames(os.path.join(root, "Test", "Test001_gt"), 5, ".bmp")
    elif dataset == "avenue":
        for v, n in enumerate((3, 4)):
            _touch_frames(os.path.join(root, "training", "frames", f"{v + 1:02d}"), n, ".jpg")
        _touch_frames(os.path.join(root, "testing", "frames", "01"), 6, ".jpg")
    else:
        for name, n in (("01_001", 3), ("02_004", 5)):
            _touch_frames(os.path.join(root, "training", "videosFrame", name), n, ".jpg")
        for part, name, n in ((1, "01_0014", 4), (2, "03_0032", 2), (2, "04_0001", 3)):
            _touch_frames(os.path.join(root, "Testing", f"frames_part{part}", name),
                          n, ".jpg")
    for mode in ("train", "test"):
        want = j_vi.VideoIndex.from_layout(dataset, root, mode)
        got = t_vi.VideoIndex.from_layout(dataset, root, mode)
        assert got.total_frames == want.total_frames > 0
        assert got.video_names == want.video_names
        assert got.frame_paths == want.frame_paths
        for name in ("video_lengths", "frame_video_idx", "scene_idx",
                     "save_scene_idx"):
            w, g = getattr(want, name), getattr(got, name)
            if w is None:
                assert g is None, name
            else:
                np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got.context_indices(2, "predict"),
                                      want.context_indices(2, "predict"))


# -- readers -------------------------------------------------------------------


def test_lazy_stacks_match_jax(tmp_path):
    """LazyFrameStack and LazyFlowStack over .npy trees: equal shapes,
    dtypes and arrays under slice, scalar and fancy indexing."""
    root = str(tmp_path / "ds")
    _write_ucsd_tree(root, {"Train": [4, 3]}, seed=4)
    jidx = j_vi.VideoIndex.from_layout(DATASET, root, "train", ".npy")
    tidx = t_vi.VideoIndex.from_layout(DATASET, root, "train", ".npy")
    of_root = str(tmp_path / "of")
    rng = np.random.default_rng(5)
    t_driver.save_flow_tree(
        rng.normal(size=(7,) + HW + (2,)).astype(np.float32), tidx, of_root, root)

    stacks = [
        (j_readers.LazyFrameStack(jidx), t_readers.LazyFrameStack(tidx)),
        (j_readers.LazyFlowStack(jidx, of_root, root),
         t_readers.LazyFlowStack(tidx, of_root, root)),
    ]
    for want, got in stacks:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert len(got) == len(want) == 7
        for key in (slice(1, 6), slice(None), 3, np.int64(6), np.array([5, 0, 2])):
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(np.asarray(stacks[0][1]), np.asarray(stacks[0][0]))
    np.testing.assert_array_equal(
        t_readers.load_frames(tidx, np.array([2, 1])),
        j_readers.load_frames(jidx, np.array([2, 1])))
    for x, y in zip(t_readers.dataset_mean_std(stacks[0][1]),
                    j_readers.dataset_mean_std(stacks[0][0])):
        np.testing.assert_array_equal(x, y)


# -- flow driver ---------------------------------------------------------------


def test_flow_pair_indices_match_jax():
    for lengths in ([5, 5], [2, 7, 3], [2], [3, 2, 2, 6]):
        want = j_driver.flow_pair_indices(j_vi.VideoIndex(list("abcd")[:len(lengths)],
                                                          np.array(lengths)))
        got = t_driver.flow_pair_indices(t_vi.VideoIndex(list("abcd")[:len(lengths)],
                                                         np.array(lengths)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # videos of 3 and 2 frames: (f0, f0), (f1, f2), (f1, f2), then (f3, f3),
    # (f3, f4)
    first, second = got
    np.testing.assert_array_equal(first[:5], [0, 1, 1, 3, 3])
    np.testing.assert_array_equal(second[:5], [0, 2, 2, 3, 4])


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("channels", [3, 1])
def test_compute_optical_flow_matches_jax(flow_nets, resident, channels):
    """Per-chunk and resident paths, a chunk (3) that does not divide the
    split (11 frames in videos of 6, 2 and 3), 3- and 1-channel frames."""
    jnet, jv, tnet = flow_nets
    lengths = np.array([6, 2, 3])
    frames = _frames(int(lengths.sum()), channels, seed=channels)
    want = j_driver.compute_optical_flow(
        jnet, jv, j_vi.VideoIndex(["a", "b", "c"], lengths), frames, chunk=3,
        model_hw=MODEL_HW, resident=resident)
    got = t_driver.compute_optical_flow(
        tnet, t_vi.VideoIndex(["a", "b", "c"], lengths), frames, chunk=3,
        model_hw=MODEL_HW, resident=resident, device="cpu")
    assert got.shape == want.shape == (11,) + HW + (2,)
    assert got.dtype == np.float32 and np.abs(got).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


class _CountingStack:
    """Array-like [lo:hi] view that records the widest slice decoded
    (tests/test_flow_driver.py's)."""

    def __init__(self, frames):
        self._f = frames
        self.shape = frames.shape
        self.max_width = 0

    def __getitem__(self, key):
        lo, hi, _ = key.indices(self.shape[0])
        self.max_width = max(self.max_width, hi - lo)
        return self._f[key]


def test_compute_optical_flow_segmented_matches_jax(flow_nets):
    """Segment boundaries inside videos (segment 5 -> 6 frames at chunk 3,
    videos of 7, 2 and 8): every frame written once, in order, equal to
    the JAX driver's, and never more than a segment plus 2 frames decoded."""
    jnet, jv, tnet = flow_nets
    lengths = np.array([7, 2, 8])
    frames = _frames(17, seed=9)
    want = np.zeros((17,) + HW + (2,), np.float32)
    j_driver.compute_optical_flow_segmented(
        jnet, jv, j_vi.VideoIndex(["a", "b", "c"], lengths), frames,
        lambda i, f: want.__setitem__(i, f), segment_frames=5, chunk=3,
        model_hw=MODEL_HW)
    got = np.zeros_like(want)
    writes = []

    def write(i, f):
        writes.append(i)
        got[i] = f

    lazy = _CountingStack(frames)
    n = t_driver.compute_optical_flow_segmented(
        tnet, t_vi.VideoIndex(["a", "b", "c"], lengths), lazy, write,
        segment_frames=5, chunk=3, model_hw=MODEL_HW, device="cpu")
    assert n == 17 and writes == list(range(17))
    assert lazy.max_width <= 6 + 2
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# -- runner and CLI ------------------------------------------------------------


def _register(monkeypatch):
    """The same .npy dataset in both packages' registries, for this test
    only."""
    for cfg_mod in (j_cfg, t_cfg):
        spec = dataclasses.replace(cfg_mod.DATASETS["UCSDped2"], name=DATASET,
                                   frame_h=HW[0], frame_w=HW[1], file_ext=".npy")
        monkeypatch.setitem(cfg_mod.DATASETS, DATASET, spec)


def _tree(base, lengths):
    _write_ucsd_tree(os.path.join(base, "raw_datasets", DATASET), lengths, seed=7)


def _read_tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = np.load(os.path.join(d, f))
    return out


@pytest.mark.parametrize("segment_frames", [None, 3])
def test_run_calc_flow_tree_matches_jax(tmp_path, monkeypatch, segment_frames):
    """The slice as a whole: run_calc_flow of both packages over one .npy
    tree, TinyFlow in place of FlowNet2 in both (its weights from
    key(0), as the JAX runner initialises FlowNet2), at the 384x512
    protocol, on the whole-split and the segmented route: the same files
    under the mirrored paths, values within atol 1e-5."""
    _register(monkeypatch)
    base = str(tmp_path)
    _tree(base, {"Train": [5, 2], "Test": [4]})
    monkeypatch.setattr(j_flownet, "FlowNet2", TinyFlow)
    x0 = jnp.zeros((1, 2) + MODEL_HW + (3,))

    def make_twin(seed, device):
        assert seed == 0 and torch.device(device).type == "cpu"
        return TorchTinyFlow(TinyFlow().init(jax.random.key(seed), x0))

    monkeypatch.setattr(t_runner, "make_flownet2", make_twin)
    cfg = t_cfg.PipelineConfig(dataset_name=DATASET)
    jcfg = j_cfg.PipelineConfig(dataset_name=DATASET, optical_flow_dir="of_jax")
    j_runner.run_calc_flow(jcfg, base, segment_frames=segment_frames,
                           use_mesh=False)
    t_runner.run_calc_flow(cfg, base, segment_frames=segment_frames,
                           device="cpu")
    want = _read_tree(os.path.join(base, "of_jax", DATASET))
    got = _read_tree(os.path.join(base, "optical_flow", DATASET))
    assert sorted(got) == sorted(want)
    assert len(got) == 11 and os.path.join("Train", "Train002", "001.npy") in got
    for rel, w in want.items():
        assert got[rel].dtype == np.float32 and got[rel].shape == HW + (2,)
        np.testing.assert_allclose(got[rel], w, rtol=0, atol=ATOL, err_msg=rel)


def test_calc_flow_cli_flag_plumbing(tmp_path, monkeypatch):
    """`calc-flow --flow-dtype bfloat16 --chunk 0` reaches run_calc_flow
    as flow_dtype='bfloat16', chunk=None, and the runner then runs the
    net in bf16 in batches of 8 (the per-dtype default)."""
    _register(monkeypatch)
    base = str(tmp_path)
    _tree(base, {"Train": [7, 3]})
    cfg_path = str(tmp_path / "c.cfg")
    with open(cfg_path, "w") as f:
        f.write(f"[shared_parameters]\ndataset_name = {DATASET}\n")
    argv = ["calc-flow", "--config", cfg_path, "--base", base, "--splits",
            "train", "--flow-dtype", "bfloat16", "--chunk", "0", "--device", "cpu"]

    calls = {}
    real = t_runner.run_calc_flow
    monkeypatch.setattr(t_runner, "run_calc_flow",
                        lambda cfg, base, **kw: calls.update(kw, cfg=cfg))
    assert t_cli.main(argv) == 0
    assert calls["flow_dtype"] == "bfloat16" and calls["chunk"] is None
    assert calls["device"] == "cpu" and calls["cfg"].dataset_name == DATASET
    assert calls["splits"] == ("train",) and calls["segment_frames"] is None

    seen = []

    class Recording(TorchTinyFlow):
        def forward(self, pair):
            seen.append((pair.shape[0], pair.dtype))
            return super().forward(pair)

    x0 = jnp.zeros((1, 2) + MODEL_HW + (3,))
    monkeypatch.setattr(t_runner, "run_calc_flow", real)
    monkeypatch.setattr(t_runner, "make_flownet2", lambda seed, device: Recording(
        TinyFlow().init(jax.random.key(seed), x0)))
    assert t_cli.main(argv) == 0
    assert seen == [(8, torch.bfloat16), (2, torch.bfloat16)]
    flows = _read_tree(os.path.join(base, "optical_flow", DATASET))
    assert len(flows) == 10
    assert all(f.dtype == np.float32 and np.isfinite(f).all() for f in flows.values())


def test_calc_flow_needs_a_card_or_cpu(tmp_path, monkeypatch, flow_nets):
    """Without a card the default device raises: run_calc_flow, the
    drivers and the CLI; nothing falls back to the CPU. A net on another
    device than the one asked for is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_cfg.PipelineConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_runner.run_calc_flow(cfg, str(tmp_path))
    idx = t_vi.VideoIndex(["a"], np.array([3]))
    frames = _frames(3)
    tnet = flow_nets[2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_driver.compute_optical_flow(tnet, idx, frames)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_driver.compute_optical_flow_segmented(tnet, idx, frames, print)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["calc-flow", "--base", str(tmp_path)])
    with pytest.raises(ValueError, match="lives on"):
        t_driver.compute_optical_flow(TorchTinyFlow(flow_nets[1]).to("meta"),
                                      idx, frames, device="cpu")
