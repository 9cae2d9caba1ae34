"""Motion serving in the port against vec_vad_tpu's: MotionStreamingScorer
(raw-only, with streamed flow maps, gray streams, appearance boxes merged,
videos of 12 / 9 / 2 / 1 frames) and MotionFlowStreamingScorer (the
TinyFlow twin of tests/test_torch_serving.py in the loop), the offline
pipeline on compute_foreground_bboxes' boxes, the device-time probe, the
refusals, clamped motion windows and `serve --motion [--live-flow]`.

One tiny seeded model per configuration (nf=4, patch 16, 48x64 frames,
saved by vec_vad_tpu as .npz and loaded by the port) is reused across
the file."""

import io
import re
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_foreground import _frames
from test_torch_serving import FLOW_HW, TinyFlow, TorchTinyFlow, _models
from test_torch_serving_surface import _workspace
from vec_vad_torch import cli as t_cli
from vec_vad_torch import config as t_config
from vec_vad_torch import runner as t_runner
from vec_vad_torch.data.video_index import VideoIndex
from vec_vad_torch.fore.detector import compute_foreground_bboxes
from vec_vad_torch.infer import infer_frame_scores_resident
from vec_vad_torch.ops.stc import pad_boxes
from vec_vad_torch.serve import MotionFlowStreamingScorer as TMotionFlow
from vec_vad_torch.serve import MotionStreamingScorer as TMotion
from vec_vad_tpu import config as j_config
from vec_vad_tpu.serve import MotionFlowStreamingScorer as JMotionFlow
from vec_vad_tpu.serve import MotionStreamingScorer as JMotion

SPEC_KW = dict(name="s", frame_h=48, frame_w=64, file_ext=".tif", scene_num=1,
               ap_score_thr=0.5, ap_min_area=16.0, cover_thr=0.6,
               mt_area_thr=16.0, mt_binary_thr=18.0, mt_extend=2,
               mt_gauss_mask_size=3)
J_SPEC, T_SPEC = j_config.DatasetSpec(**SPEC_KW), t_config.DatasetSpec(**SPEC_KW)
LENGTHS = (12, 9, 2, 1)
# the JAX package's own bound between its serving and offline paths
# (tests/test_serve.py), relative to the largest score here
REL = 2e-4
AP = np.array([[4.0, 6.0, 22.0, 30.0]], np.float32)  # merged on every 4th frame


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{use_flow: (JAX model, port model)}, one seeded block each."""
    base = tmp_path_factory.mktemp("motion_models")
    return {uf: _models(base, 31 + uf, use_flow=uf) for uf in (False, True)}


@pytest.fixture(scope="module")
def stream():
    frames = _frames(LENGTHS, seed=11)
    flows = np.random.default_rng(4).normal(
        0, 1.5, frames.shape[:3] + (2,)).astype(np.float32)
    return frames, flows


@pytest.fixture(scope="module")
def flow_nets():
    net = TinyFlow()
    v = net.init(jax.random.key(7), jnp.zeros((1, 2) + FLOW_HW + (3,)))
    return net, v, TorchTinyFlow(v)


def _serve(scorer, frames, flows=None, lengths=LENGTHS, ap_every=4, probe=None):
    """Stream videos of `lengths`; per video, the pushes' scores then
    end_video()'s, which must add up to the video's length."""
    out, i = [], 0
    for ln in lengths:
        scorer.start_video()
        vid = []
        for t in range(ln):
            kw = {} if flows is None else {"flow": flows[i]}
            if ap_every and t % ap_every == 1:
                kw["ap_boxes"] = AP
            s = scorer.push(frames[i], **kw)
            if s is not None:
                vid.append(s)
            if probe is not None and t == 5:
                probe(scorer, frames[i])
            i += 1
        vid += scorer.end_video()
        assert len(vid) == ln
        out += vid
    return np.asarray(out, np.float64)


def _assert_close(got, want, rel=REL):
    """Frames without a scoring box (-big_number) match exactly; the rest
    within `rel` of the largest |score|."""
    empty = want <= -1e5
    np.testing.assert_array_equal(got[empty], want[empty])
    assert (~empty).sum() > len(want) // 2
    err = np.max(np.abs(got[~empty] - want[~empty])) / np.max(np.abs(want[~empty]))
    assert err <= rel, err


@pytest.mark.parametrize("mode", ["raw_only", "flow", "gray"])
def test_motion_scorer_matches_jax(models, stream, mode):
    frames, flows = stream
    jm, tm = models[mode == "flow"]
    kw = {"gray_stream": True} if mode == "gray" else {}
    fl = flows if mode == "flow" else None
    if mode == "gray":
        frames = np.repeat(frames[..., :1], 3, -1)  # gray content, 3 channels
    want = _serve(JMotion.from_model(jm, spec=J_SPEC, **kw), frames, fl)
    got = _serve(TMotion.from_model(tm, spec=T_SPEC, device="cpu", **kw), frames, fl)
    _assert_close(got, want)
    if mode == "gray":  # a gray stream serves as its 3-channel replica
        color = _serve(TMotion.from_model(tm, spec=T_SPEC, device="cpu"), frames)
        np.testing.assert_array_equal(got, color)
    if mode == "raw_only":  # the 1-frame video: an empty map, one ap box
        one = TMotion.from_model(tm, spec=T_SPEC, device="cpu")
        one.start_video()
        assert one.push(frames[0]) is None
        assert one.end_video() == [-one.big_number]


def test_motion_scorer_matches_offline_pipeline(models, stream):
    """Served scores equal the port's offline pipeline run with
    compute_foreground_bboxes' motion-mode boxes (no 1-frame video: the
    offline hard-border stage rejects those)."""
    frames, _ = stream
    lengths = LENGTHS[:3]
    frames = frames[:sum(lengths)]
    _, tm = models[False]
    cfg = tm.cfg
    idx = VideoIndex([f"v{i}" for i in range(3)], np.asarray(lengths))
    boxes = compute_foreground_bboxes(
        cfg, T_SPEC, idx, frames=frames,
        detector=lambda img: (np.zeros((0, 4)), np.zeros(0)), chunk=5, device="cpu")
    assert sum(b.shape[0] for b in boxes) > 0
    blk = tm.blocks[(0, 0, 0)]
    boxes_pad, valid = pad_boxes(boxes, cfg.fore.max_boxes_per_frame)
    windows = idx.context_indices(cfg.model.context_frame_num, cfg.model.border_mode)
    offline = infer_frame_scores_resident(
        cfg, blk.state_dict, (*blk.raw_stats, 0.0, 1.0), frames, windows,
        boxes_pad, valid, device="cpu")
    streamed = _serve(TMotion.from_model(tm, spec=T_SPEC, device="cpu"), frames,
                      lengths=lengths, ap_every=0)
    _assert_close(streamed, np.asarray(offline, np.float64))


def test_motion_flow_scorer_matches_jax(models, stream, flow_nets):
    frames, _ = stream
    jm, tm = models[True]
    net, v, tnet = flow_nets
    want = _serve(JMotionFlow.from_model(jm, spec=J_SPEC, flow_net=net,
                                         flow_variables=v, flow_model_hw=FLOW_HW),
                  frames)
    got = _serve(TMotionFlow.from_model(tm, spec=T_SPEC, flow_net=tnet,
                                        flow_model_hw=FLOW_HW, device="cpu"), frames)
    _assert_close(got, want)


def test_time_device_step_leaves_the_conveyor_unchanged(models, stream, flow_nets):
    """A probe mid-video (after push 5) times the fused step on clones of
    the rings: the stream's scores equal an unprobed run's bit for bit."""
    frames, flows = stream
    _, tm = models[True]
    times = []

    def probe(scorer, frame):
        times.append(scorer.time_device_step(frame, AP, k=2, repeats=1))

    for make, fl in ((lambda: TMotion.from_model(tm, spec=T_SPEC, device="cpu"),
                      flows),
                     (lambda: TMotionFlow.from_model(
                         tm, spec=T_SPEC, flow_net=flow_nets[2],
                         flow_model_hw=FLOW_HW, device="cpu"), None)):
        plain = _serve(make(), frames, fl, lengths=LENGTHS[:2])
        probed = _serve(make(), frames, fl, lengths=LENGTHS[:2], probe=probe)
        np.testing.assert_array_equal(probed, plain)
    assert len(times) == 4 and all(t > 0 for t in times)


def test_motion_scorers_refuse(models, stream, flow_nets, tmp_path):
    frames, flows = stream
    jm, tm = models[True]
    sc = TMotion.from_model(tm, spec=T_SPEC, device="cpu")
    with pytest.raises(NotImplementedError, match="push frames one at a time"):
        sc.push_many(frames[:2], [AP, AP])
    with pytest.raises(ValueError, match="call start_video"):
        sc.push(frames[0])
    sc.start_video()
    sc.push(frames[0], flow=flows[0])
    with pytest.raises(ValueError, match="end_video"):
        sc.start_video()
    with pytest.raises(ValueError, match="pipeline_depth must be 0"):
        TMotion.from_model(tm, spec=T_SPEC, device="cpu", pipeline_depth=2)
    live = TMotionFlow.from_model(tm, spec=T_SPEC, flow_net=flow_nets[2],
                                  flow_model_hw=FLOW_HW, device="cpu")
    live.start_video()
    with pytest.raises(ValueError, match="computes flow in the loop"):
        live.push(frames[0], flow=flows[0])
    with pytest.raises(ValueError, match="two-stream"):
        TMotionFlow.from_model(models[False][1], spec=T_SPEC, flow_net=flow_nets[2],
                               device="cpu")
    with pytest.raises(SystemExit, match="single-camera"):
        t_cli.main(["serve", "--motion", "--cameras", "2", "--base", str(tmp_path),
                    "--device", "cpu"])


def test_out_of_range_motion_windows_clamp(models, stream):
    """Motion-window ring slots outside the ring are clamped into it
    (jnp.take(mode="clip") semantics), as every other ring gather."""
    frames, _ = stream
    _, tm = models[False]
    sc = TMotion.from_model(tm, spec=T_SPEC, device="cpu")
    sc.start_video()
    for f in frames[:4]:
        sc.push(f)
    boxes = np.zeros((sc.K, 4), np.float32)
    rlen = sc._rlen
    maps = []
    for mwin in (np.array([-3, 1, rlen + 4]), np.array([0, 1, rlen - 1])):
        sc._mwin = lambda mapped, tail, mwin=mwin: mwin
        args = sc._motion_args(torch.from_numpy(frames[3]), None, 3, -1, 2, None, boxes, 0)
        maps.append(sc._motion_step(*args))
    assert maps[0].shape == (4 * (sc.B * sc.K + sc.K) + 48 * 64,)
    torch.testing.assert_close(maps[0], maps[1], rtol=0, atol=0)
    assert maps[1][-48 * 64:].any()


def _cli(*argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert t_cli.main(list(argv)) == 0
    return buf.getvalue()


def test_serve_motion_cli(tmp_path, monkeypatch, flow_nets):
    """On a workspace without bbox fixtures: precompute-boxes, train and
    test, then `serve --motion`, whose streamed AUROC equals test's (both
    on the motion boxes); on a two-stream config with a flow tree from
    the TinyFlow twin (calc-flow's protocol), `serve --motion
    --live-flow` does the same."""
    cfg = _workspace(tmp_path, use_flow=False)
    root = Path(tmp_path) / "raw_datasets"
    for f in root.glob("*/bboxes_*.npy"):
        f.unlink()
    common = ("--config", cfg, "--base", str(tmp_path), "--device", "cpu")
    assert "wrote" in _cli("precompute-boxes", *common)
    _cli("train", *common)
    test_auc = re.search(r"frame-level AUROC: ([\d.]+)", _cli("test", *common))[1]
    out = _cli("serve", *common, "--motion")
    assert re.search(r"p90 [\d.]+ ms", out), out
    assert re.search(r"frame-level AUROC \(streamed\): ([\d.]+)", out)[1] == test_auc

    flow_cfg = Path(tmp_path) / "flow.cfg"
    flow_cfg.write_text(open(cfg).read().replace("useFlow = False", "useFlow = True"))
    tcfg = t_config.load_ini_config(str(flow_cfg))
    monkeypatch.setattr(t_runner, "make_flownet2", lambda seed, dev: flow_nets[2])
    t_runner.run_calc_flow(tcfg, str(tmp_path), device="cpu")
    monkeypatch.setattr(t_cli, "_build_live_flow", lambda args, device: (
        flow_nets[2], {"flow_compute_dtype": torch.float32}))
    common = ("--config", str(flow_cfg), "--base", str(tmp_path), "--device", "cpu")
    _cli("train", *common)
    test_auc = re.search(r"frame-level AUROC: ([\d.]+)", _cli("test", *common))[1]
    out = _cli("serve", *common, "--motion", "--live-flow")
    assert re.search(r"frame-level AUROC \(streamed\): ([\d.]+)", out)[1] == test_auc
