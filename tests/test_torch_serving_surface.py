"""The serving surface of the port against vec_vad_tpu's: push_many of
both scorers, the camera fleets, bf16 scoring, the device-time probes,
the two serving repairs (f32 scoring with TF32 off; a pipelined result
copied to the host when its step is queued) and the `serve` CLI.

Same sizes, models and flow stand-in as tests/test_torch_serving.py
(nf=4, patch 16, 48x64 frames, the TinyFlow twin at 24x32): the same
.npz model (saved by vec_vad_tpu, loaded by the port) and the same frames
go through both packages. One JAX scorer per configuration is reused
across the file, since each new k or C compiles again."""

import dataclasses
import io
import re
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_serving import FLOW_HW, TinyFlow, TorchTinyFlow, _models
from vec_vad_torch import cli as t_cli
from vec_vad_torch import config as t_config
from vec_vad_torch.serve import FlowStreamingScorer as TFlow
from vec_vad_torch.serve import MultiCameraFlowScorer as TFlowFleet
from vec_vad_torch.serve import MultiCameraScorer as TFleet
from vec_vad_torch.serve import StreamingScorer as TScorer
from vec_vad_tpu.data.synthetic import make_synthetic_dataset
from vec_vad_tpu.serve import FlowStreamingScorer as JFlow
from vec_vad_tpu.serve import MultiCameraFlowScorer as JFlowFleet
from vec_vad_tpu.serve import MultiCameraScorer as JFleet
from vec_vad_tpu.serve import StreamingScorer as JScorer

# the JAX package's own bound between its serving and offline paths
TOL = dict(rtol=2e-4, atol=2e-4)
# bf16 scores across the packages, relative to the largest |score|: each
# package rounds its bf16 convolutions and BatchNorm in its own order, and
# the z-normalisation scales that noise by mu/sd of the training scores.
# Observed 1.8e-3 (1.2e-2 of scores up to 7.05), the f32 port 7.0e-3 from
# JAX's bf16. The resident scorer's absolute 5e-3
# (tests/test_torch_dataset_scale.py) holds scores up to 4.9 from a
# trained block; these blocks' raw z-scores reach 10.6 without flow.
BF16_SCORE_REL = 3e-3
K_BATCH = 4  # push_many's k throughout: one JAX compile per scorer
GRID_KEYS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0), (1, 1, 1))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def split():
    """16 frames (two 8-frame synthetic videos), their boxes, and seeded
    flow maps."""
    ds = make_synthetic_dataset(frames_per_video=8, n_train_videos=1,
                                n_test_videos=2, frame_h=48, frame_w=64,
                                seed=21)
    flows = np.random.default_rng(8).normal(
        0, 1.5, ds.test_frames.shape[:3] + (2,)).astype(np.float32)
    return ds.test_frames, ds.test_boxes, flows


@pytest.fixture(scope="module")
def flow_nets():
    net = TinyFlow()
    v = net.init(jax.random.key(7), jnp.zeros((1, 2) + FLOW_HW + (3,)))
    return net, v, TorchTinyFlow(v)


@pytest.fixture(scope="module")
def two_stream(tmp_path_factory):
    """(JAX model, port model) of one 1x1 two-stream block."""
    return _models(tmp_path_factory.mktemp("two_stream"), 11)


@pytest.fixture(scope="module")
def jax_two_stream(two_stream):
    return JScorer.from_model(two_stream[0])


def _batches(scorer, frames, boxes, flows, lengths, **kw):
    """Stream videos of `lengths` through push_many in batches of K_BATCH;
    returns the concatenated scores."""
    out, i = [], 0
    for ln in lengths:
        scorer.start_video()
        for lo in range(0, ln, K_BATCH):
            hi = min(lo + K_BATCH, ln)
            fl = None if flows is None else flows[i + lo:i + hi]
            out += scorer.push_many(frames[i + lo:i + hi], boxes[i + lo:i + hi],
                                    fl, **kw)
        i += ln
    return np.asarray(out, np.float32)


def _pushes(scorer, frames, boxes, flows, lengths):
    out, i = [], 0
    for ln in lengths:
        scorer.start_video()
        for _ in range(ln):
            s = scorer.push(frames[i], boxes[i],
                            flow=None if flows is None else flows[i])
            if s is not None:
                out.append(s)
            i += 1
    return np.asarray(out + scorer.drain(), np.float32)


@pytest.mark.parametrize("mode", ["flow", "no_flow", "raw_only"])
def test_push_many_matches_jax(tmp_path, split, two_stream, jax_two_stream, mode):
    """push_many in batches of 4 over videos of 8 and 4 frames against
    vec_vad_tpu's push_many: two-stream with flow maps, two-stream with
    flows=None (zero flow cubes, motion filter bypassed) and raw-only.
    The batch's later frames read the ring and the batch both, across a
    batch boundary inside a video."""
    frames, boxes, flows = split
    lengths = (8, 4)
    if mode == "raw_only":
        jmodel, tmodel = _models(tmp_path, 12, use_flow=False)
        js = JScorer.from_model(jmodel)
    else:
        (jmodel, tmodel), js = two_stream, jax_two_stream
    fl = flows if mode == "flow" else None
    want = _batches(js, frames, boxes, fl, lengths)
    got = _batches(TScorer.from_model(tmodel, device="cpu"), frames, boxes, fl,
                   lengths)
    assert got.shape == want.shape == (12,)
    assert np.isfinite(got).all() and np.ptp(got) > 0.1
    np.testing.assert_allclose(got, want, **TOL)
    # and equal to the port's own k pushes
    np.testing.assert_allclose(
        _pushes(TScorer.from_model(tmodel, device="cpu"), frames, boxes, fl, lengths),
        got, **TOL)


def test_live_flow_push_many_matches_jax(tmp_path, split, flow_nets):
    """Live-flow push_many under pipeline_depth 2: a video's first batch
    (k-1 emitted, fewer while the pipeline fills), a steady batch, the
    end_video tail after it, then a 2-frame video by push(); each call's
    emitted scores against vec_vad_tpu's same calls."""
    frames, boxes, _ = split
    jnet, jv, tnet = flow_nets
    jmodel, tmodel = _models(tmp_path, 13)
    kw = dict(flow_model_hw=FLOW_HW, pipeline_depth=2)
    js = JFlow.from_model(jmodel, flow_net=jnet, flow_variables=jv, **kw)
    ts = TFlow.from_model(tmodel, flow_net=tnet, device="cpu", **kw)

    def run(sc):
        calls = []
        sc.start_video()
        calls.append(sc.push_many(frames[0:4], boxes[0:4]))
        calls.append(sc.push_many(frames[4:8], boxes[4:8]))
        calls.append([sc.end_video()])
        sc.start_video()
        calls.append([sc.push(frames[8], boxes[8]), sc.push(frames[9], boxes[9]),
                      sc.end_video()])
        calls.append(sc.drain())
        return calls

    want, got = run(js), run(ts)
    assert [len(c) for c in got] == [len(c) for c in want] == [1, 4, 1, 3, 2]
    for g, w in zip(got, want):
        assert [x is None for x in g] == [x is None for x in w]
        np.testing.assert_allclose([x for x in g if x is not None],
                                   [x for x in w if x is not None], **TOL)


def _fleet_feed(split, n_ticks, C):
    """Camera c streams the split's frames from offset 5c (wrapping)."""
    frames, boxes, flows = split
    idx = [[(5 * c + t) % len(frames) for c in range(C)] for t in range(n_ticks)]
    return [(frames[ix], [boxes[i] for i in ix], flows[ix]) for ix in idx]


def test_multicamera_matches_jax(tmp_path, split):
    """MultiCameraScorer at C = 3 on a 2x2 grid with an untrained cell and
    two scene rows: camera 1 on scene 2 from the start, camera 2 cut to a
    new video of scene 2 mid-stream, flows streamed except on one tick
    (zero flow cubes, motion filter bypassed), pipeline_depth 1; every
    tick against vec_vad_tpu's fleet."""
    jmodel, tmodel = _models(tmp_path, 14, keys=GRID_KEYS, grid=(2, 2))
    kw = dict(n_cameras=3, route_hw=(48, 64), pipeline_depth=1)
    js, ts = JFleet.from_model(jmodel, **kw), TFleet.from_model(tmodel, device="cpu",
                                                                **kw)

    def run(sc):
        out = []
        sc.start_video()
        sc.start_video(camera=1, scene=2)
        for t, (f, b, fl) in enumerate(_fleet_feed(split, 9, 3)):
            if t == 4:
                sc.start_video(camera=2, scene=2)
            out.append(sc.push_tick(f, b, flows=None if t == 6 else fl))
        return [o for o in out if o is not None] + sc.drain()

    want, got = np.asarray(run(js)), np.asarray(run(ts))
    assert got.shape == want.shape == (9, 3)
    assert len(np.unique(got)) > 10
    np.testing.assert_allclose(got, want, **TOL)


def test_live_fleet_matches_jax(tmp_path, split, flow_nets):
    """MultiCameraFlowScorer at C = 2: a 5-frame video, then a 2-frame one
    (both its frames' pairs are (f0, f0)), each camera on its own feed;
    every emitted tick against vec_vad_tpu's live fleet."""
    jnet, jv, tnet = flow_nets
    jmodel, tmodel = _models(tmp_path, 15)
    kw = dict(n_cameras=2, flow_model_hw=FLOW_HW)
    js = JFlowFleet.from_model(jmodel, flow_net=jnet, flow_variables=jv, **kw)
    ts = TFlowFleet.from_model(tmodel, flow_net=tnet, device="cpu", **kw)
    feed = _fleet_feed(split, 7, 2)

    def run(sc):
        out = []
        for lo, hi in ((0, 5), (5, 7)):
            sc.start_video()
            out += [sc.push_tick(f, b) for f, b, _ in feed[lo:hi]]
            out.append(sc.end_video())
        return out

    want, got = run(js), run(ts)
    assert [o is None for o in got] == [o is None for o in want]
    got = np.asarray([o for o in got if o is not None])
    assert got.shape == (7, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, [o for o in want if o is not None], **TOL)


def test_bf16_scoring_matches_jax(split, two_stream):
    """compute_dtype bfloat16 (given by name) against vec_vad_tpu's bf16
    scorer on the same stream, within the bf16 score bound; the f32
    scores fall outside it. The flow maps are drawn as the blocks' flow
    statistics were (N(0, 0.3), tests/test_torch_serving.py _models): the
    split's N(0, 1.5) maps put the flow z-scores near 220, where either
    package's bf16 noise (0.16 between them) exceeds the gap between
    bf16 and f32 (0.11), so no bound could tell the two apart."""
    frames, boxes, _ = split
    flows = np.random.default_rng(8).normal(
        0, 0.3, frames.shape[:3] + (2,)).astype(np.float32)
    jmodel, tmodel = two_stream
    lengths = (8, 4)
    want = _pushes(JScorer.from_model(jmodel, compute_dtype=jnp.bfloat16),
                   frames, boxes, flows, lengths)
    sc = TScorer.from_model(tmodel, compute_dtype="bfloat16", device="cpu")
    assert sc.compute_dtype == torch.bfloat16
    got = _pushes(sc, frames, boxes, flows, lengths)
    f32 = _pushes(TScorer.from_model(tmodel, device="cpu"), frames, boxes, flows,
                  lengths)
    bound = BF16_SCORE_REL * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), bound)
    assert np.abs(f32 - want).max() > bound
    with pytest.raises(ValueError, match="compute dtype"):
        TScorer.from_model(tmodel, compute_dtype="float16", device="cpu")


def test_f32_scoring_runs_with_tf32_off(split, two_stream, flow_nets):
    """Every f32 scoring call turns both TF32 flags off for its forwards
    and gives the caller's flags back: push, push_many, the fleet tick,
    the live-flow push (its flow net too) and a probe."""
    frames, boxes, flows = split
    tmodel = two_stream[1]
    seen = []

    def hook(m, i, o):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))

    sc = TScorer.from_model(tmodel, device="cpu")
    fleet = TFleet.from_model(tmodel, n_cameras=2, device="cpu")
    live = TFlow.from_model(tmodel, flow_net=flow_nets[2], flow_model_hw=FLOW_HW,
                            device="cpu")
    nets = [s._forwards[0] for s in (sc, fleet, live)] + [live.flow_net]
    handles = [n.register_forward_hook(hook) for n in nets]
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sc.start_video()
        sc.push(frames[0], boxes[0], flow=flows[0])
        sc.push_many(frames[1:3], boxes[1:3], flows[1:3])
        sc.time_device_step(frames[3], boxes[3], k=1, repeats=1)
        fleet.start_video()
        fleet.push_tick(frames[:2], boxes[:2], flows=flows[:2])
        live.start_video()
        live.push(frames[0], boxes[0])
        after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        for h in handles:
            h.remove()
    assert len(seen) == 7, seen
    assert all(s == (False, False) for s in seen), seen
    assert after == (True, True)


def _corrupt_results_after_dispatch(scorer):
    """Wrap the scorer's scoring so every result vector it returns is
    overwritten with NaN right after its step is queued (on the card:
    by a later kernel on the same stream). A result read only when it
    leaves the pipeline would read the NaNs."""
    score = scorer._score_windows
    queued = []

    def wrapped(*a):
        if queued:
            queued.pop().fill_(float("nan"))
        out = score(*a)
        queued.append(out)
        return out

    scorer._score_windows = wrapped
    return queued


def test_pipelined_results_copied_at_dispatch(split, two_stream, flow_nets):
    """pipeline_depth 2: scores equal depth 0's bit for bit, and each
    result was copied to the host when its step was queued — the device
    vector overwritten right after does not reach the scores (single
    stream, live-flow push_many and the fleet)."""
    frames, boxes, flows = split
    tmodel = two_stream[1]
    lengths = (8, 4)
    want = _pushes(TScorer.from_model(tmodel, device="cpu"), frames, boxes, flows,
                   lengths)
    piped = TScorer.from_model(tmodel, pipeline_depth=2, device="cpu")
    queued = _corrupt_results_after_dispatch(piped)
    got = []
    i = 0
    for ln in lengths:
        piped.start_video()
        for _ in range(ln):
            got.append(piped.push(frames[i], boxes[i], flow=flows[i]))
            i += 1
            if queued:
                queued.pop().fill_(float("nan"))
    assert got[:2] == [None, None]
    got = np.asarray([s for s in got if s is not None] + piped.drain(), np.float32)
    np.testing.assert_array_equal(got, want)

    kw = dict(flow_net=flow_nets[2], flow_model_hw=FLOW_HW, device="cpu")

    def live_run(sc, corrupt):
        queued = _corrupt_results_after_dispatch(sc) if corrupt else []
        sc.start_video()
        out = sc.push_many(frames[:5], boxes[:5])
        while queued:
            queued.pop().fill_(float("nan"))
        out += sc.push_many(frames[5:8], boxes[5:8]) + [sc.end_video()]
        return [s for s in out if s is not None] + sc.drain()

    np.testing.assert_array_equal(live_run(TFlow.from_model(tmodel, pipeline_depth=2,
                                                            **kw), True),
                                  live_run(TFlow.from_model(tmodel, **kw), False))

    def fleet_run(sc, corrupt):
        queued = _corrupt_results_after_dispatch(sc) if corrupt else []
        sc.start_video()
        out = []
        for f, b, fl in _fleet_feed(split, 5, 2):
            out.append(sc.push_tick(f, b, flows=fl))
            while queued:
                queued.pop().fill_(float("nan"))
        return [o for o in out if o is not None] + sc.drain()

    np.testing.assert_array_equal(
        fleet_run(TFleet.from_model(tmodel, n_cameras=2, pipeline_depth=2,
                                    device="cpu"), True),
        fleet_run(TFleet.from_model(tmodel, n_cameras=2, device="cpu"), False))


def test_probes_leave_the_stream_unchanged(split, two_stream, flow_nets):
    """time_device_step / time_device_tick mid-stream return a positive
    time and leave the scores that follow equal to an unprobed run's;
    the fleets refuse the single-stream forms."""
    frames, boxes, flows = split
    tmodel = two_stream[1]
    fk = dict(flow_net=flow_nets[2], flow_model_hw=FLOW_HW, device="cpu")
    feed = _fleet_feed(split, 6, 2)

    def single(sc, probe):
        sc.start_video()
        out = [sc.push(frames[t], boxes[t], flow=flows[t]) for t in range(3)]
        if probe:
            assert sc.time_device_step(frames[3], boxes[3], k=2, repeats=2) > 0
        return out + [sc.push(frames[t], boxes[t], flow=flows[t]) for t in range(3, 6)]

    def live(sc, probe):
        sc.start_video()
        out = [sc.push(frames[t], boxes[t]) for t in range(3)]
        if probe:
            assert sc.time_device_step(frames[3], boxes[3], k=2, repeats=1) > 0
        return out + [sc.push(frames[t], boxes[t]) for t in range(3, 6)] + [sc.end_video()]

    def fleet(sc, probe):
        sc.start_video()
        out = [sc.push_tick(f, b, flows=fl) for f, b, fl in feed[:3]]
        if probe:
            assert sc.time_device_tick(feed[3][0], feed[3][1], k=2, repeats=1) > 0
        return out + [sc.push_tick(f, b, flows=fl) for f, b, fl in feed[3:]]

    def live_fleet(sc, probe):
        sc.start_video()
        out = [sc.push_tick(f, b) for f, b, _ in feed[:3]]
        if probe:
            assert sc.time_device_tick(feed[3][0], feed[3][1], k=2, repeats=1) > 0
        return out + [sc.push_tick(f, b) for f, b, _ in feed[3:]] + [sc.end_video()]

    for run, make in (
        (single, lambda: TScorer.from_model(tmodel, device="cpu")),
        (live, lambda: TFlow.from_model(tmodel, **fk)),
        (fleet, lambda: TFleet.from_model(tmodel, n_cameras=2, device="cpu")),
        (live_fleet, lambda: TFlowFleet.from_model(tmodel, n_cameras=2, **fk)),
    ):
        want = run(make(), False)
        assert run(make(), True) == want, run.__name__
    for sc in (TFleet.from_model(tmodel, n_cameras=2, device="cpu"),
               TFlowFleet.from_model(tmodel, n_cameras=2, **fk)):
        for name in ("push", "push_many", "time_device_step"):
            with pytest.raises(NotImplementedError):
                getattr(sc, name)(frames[0], boxes[0])


# -- the serve CLI ------------------------------------------------------

CLI_DATASET = "ped2npy_serving_surface"


def _workspace(base: Path, use_flow: bool) -> str:
    """A tiny UCSD-layout .npy workspace (2 + 2 videos of 20 frames at
    48x64, bbox fixtures, .bmp label masks) and its config."""
    import chip_smoke

    if CLI_DATASET not in t_config.DATASETS:
        t_config.register_dataset(dataclasses.replace(
            t_config.DATASETS["UCSDped2"], name=CLI_DATASET, file_ext=".npy"))
    chip_smoke.write_train_test_tree(base / "raw_datasets" / CLI_DATASET, 3,
                                     {"Train": (20, 20), "Test": (20, 20)}, (48, 64),
                                     masks=True)
    cfg = base / "config.cfg"
    cfg.write_text(
        f"[shared_parameters]\ndataset_name = {CLI_DATASET}\n[{CLI_DATASET}]\n"
        "patch_size = 16\n[SelfComplete]\nnf = 4\nepochs = 1\nbatch_size = 16\n"
        f"useFlow = {use_flow}\ncontext_of_num = 0\n")
    return str(cfg)


def _cli(*argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert t_cli.main(list(argv)) == 0
    return buf.getvalue()


def test_serve_cli(tmp_path, monkeypatch, flow_nets):
    """`serve --device cpu` on a trained raw-only workspace: the streamed
    AUROC over the whole split equals `test`'s, and `--cameras 2` reports
    a zero cross-camera spread. On a two-stream model, `--live-flow`
    (the flow net stubbed by the TinyFlow twin) and its fleet run; on
    the raw-only config it fails before any flow net is built."""
    from vec_vad_torch.runner import model_path
    from vec_vad_torch.runtime.artifacts import save_vad_model

    cfg = _workspace(tmp_path, use_flow=False)
    common = ("--config", cfg, "--base", str(tmp_path), "--device", "cpu")
    _cli("train", *common)
    test_auc = re.search(r"frame-level AUROC: ([\d.]+)", _cli("test", *common))[1]
    out = _cli("serve", *common)
    assert re.search(r"frame-level AUROC \(streamed\): ([\d.]+)", out)[1] == test_auc
    out = _cli("serve", *common, "--cameras", "2", "--frames", "6")
    assert "cross-camera score spread 0.00e+00" in out, out

    built = []

    def stub(args, device):
        built.append(args.flow_dtype)
        return flow_nets[2], {"flow_compute_dtype": torch.float32}

    monkeypatch.setattr(t_cli, "_build_live_flow", stub)
    with pytest.raises(SystemExit, match="raw-only"):
        t_cli.main(["serve", *common, "--live-flow"])
    assert not built

    # a two-stream model under the same workspace (seeded, not trained)
    flow_cfg = tmp_path / "flow.cfg"
    flow_cfg.write_text(open(cfg).read().replace("useFlow = False", "useFlow = True"))
    tcfg = t_config.load_ini_config(str(flow_cfg))
    tmodel = _models(tmp_path, 16)[1]
    path = model_path(tcfg, str(tmp_path))
    save_vad_model(path, dataclasses.replace(tmodel, cfg=tcfg))
    common = ("--config", str(flow_cfg), "--base", str(tmp_path), "--device", "cpu")
    out = _cli("serve", *common, "--live-flow", "--frames", "5")
    assert re.search(r"streamed 5 frames: median latency", out), out
    out = _cli("serve", *common, "--live-flow", "--cameras", "2", "--frames", "4",
               "--flow-dtype", "float32")
    assert "cross-camera score spread 0.00e+00" in out, out
    assert built == ["float32", "float32"]
