"""The slice as a whole: the port's FlowStreamingScorer and vec_vad_tpu's
stream the same synthetic test split with the same completion weights
(saved by vec_vad_tpu as .npz, loaded by the port) and the same flow net,
and must emit the same scores frame for frame — including a 2-frame
video (the tail pair rule), pipeline_depth, gray streams and a 2x2 block
grid with an untrained cell.

The flow net is a small stand-in with FlowNet2's serving contract (as in
tests/test_flow_serving.py), twinned in torch with carried weights:
FlowNet2 parity itself is tests/test_torch_flownet.py's."""

import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from vec_vad_torch.runtime.artifacts import load_vad_model
from vec_vad_torch.serve import FlowStreamingScorer as TScorer
from vec_vad_torch.serve import StreamingScorer as TStreamingScorer
from vec_vad_tpu.config import CompletionConfig, ForegroundConfig, PipelineConfig
from vec_vad_tpu.data.synthetic import make_synthetic_dataset
from vec_vad_tpu.models.completion import make_completion_net
from vec_vad_tpu.pipeline import VadModel
from vec_vad_tpu.runtime.artifacts import save_vad_model
from vec_vad_tpu.serve import FlowStreamingScorer as JScorer
from vec_vad_tpu.serve import StreamingScorer as JStreamingScorer
from vec_vad_tpu.train.trainer import TrainedBlock

FLOW_HW = (24, 32)  # tiny stand-in for the driver's 384x512 protocol
LENGTHS = (8, 2)  # a video, then a 2-frame video (both pairs (f0, f0))
# the JAX package's own bound between its serving and offline paths
# (tests/test_flow_serving.py)
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class TinyFlow(fnn.Module):
    """(B, 2, mh, mw, 3) frame pairs in 0..255 -> (B, mh, mw, 2) flow."""

    @fnn.compact
    def __call__(self, pair, train: bool = False):
        x = jnp.concatenate([pair[:, 0], pair[:, 1]], axis=-1) / 255.0
        x = fnn.relu(fnn.Conv(8, (3, 3))(x))
        return fnn.Conv(2, (3, 3))(x)


class TorchTinyFlow(torch.nn.Module):
    """TinyFlow's torch twin, weights carried from its flax variables."""

    def __init__(self, variables):
        super().__init__()
        p = variables["params"]
        self.w = torch.nn.ParameterList([
            torch.nn.Parameter(torch.from_numpy(
                np.array(p[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1).copy()))
            for i in (0, 1)
        ])
        self.b = torch.nn.ParameterList([
            torch.nn.Parameter(torch.from_numpy(np.array(p[f"Conv_{i}"]["bias"])))
            for i in (0, 1)
        ])

    def forward(self, pair):
        x = torch.cat([pair[:, 0], pair[:, 1]], dim=-1) / 255.0
        x = F.relu(F.conv2d(x.permute(0, 3, 1, 2), self.w[0], self.b[0], padding=1))
        return F.conv2d(x, self.w[1], self.b[1], padding=1).permute(0, 2, 3, 1)


@pytest.fixture(scope="module")
def flow_nets():
    net = TinyFlow()
    v = net.init(jax.random.key(7), jnp.zeros((1, 2) + FLOW_HW + (3,)))
    return net, v, TorchTinyFlow(v)


@pytest.fixture(scope="module")
def split():
    ds = make_synthetic_dataset(frames_per_video=8, n_train_videos=1,
                                n_test_videos=2, frame_h=48, frame_w=64,
                                seed=21)
    n = sum(LENGTHS)
    return ds.test_frames[:n], ds.test_boxes[:n]


def _models(tmp_path, seed, keys=((0, 0, 0),), grid=(1, 1), use_flow=True):
    """A JAX two-stream 5raw1of (or raw-only) VadModel (nf=4, patch 16) with random
    weights, random BN statistics and seeded training scores scaled to
    the nets' own error sums (so fused scores are O(1)-O(10)), and the
    same model as the port loads it from vec_vad_tpu's .npz."""
    cfg = PipelineConfig(
        dataset_name="UCSDped2",
        fore=ForegroundConfig(patch_size=16, max_boxes_per_frame=8,
                              h_block=grid[0], w_block=grid[1]),
        model=CompletionConfig(nf=4, context_of_num=0, use_flow=use_flow),
    )
    net = make_completion_net(cfg.model)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (4, 16, 16, 15)).astype(np.float32)
    x_of = rng.normal(0, 0.3, (4, 16, 16, 2)).astype(np.float32)
    blocks = {}
    for i, key in enumerate(keys):
        v = net.init(jax.random.key(seed + i), x, x_of, False)
        stats = jax.tree.map(
            lambda a: np.asarray(a) * rng.uniform(0.8, 1.2, np.shape(a)),
            v["batch_stats"],
        )
        params = jax.tree.map(np.asarray, v["params"])
        out = net.apply({"params": params, "batch_stats": stats}, x, x_of, False)
        raw = float(jnp.sum(jnp.square(out.raw_out - out.raw_tgt)) / 4)
        of_scores = None
        if use_flow:
            of = float(jnp.sum(jnp.square(out.of_out - out.of_tgt)) / 4)
            of_scores = of * (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
        blocks[key] = TrainedBlock(
            params, stats,
            raw * (1 + 0.1 * rng.normal(size=16)).astype(np.float32),
            of_scores,
        )
    jmodel = VadModel(cfg=cfg, blocks=blocks)
    path = str(tmp_path / f"model{seed}.npz")
    save_vad_model(path, jmodel)
    return jmodel, load_vad_model(path)


def _stream(scorer, frames, boxes, lengths=LENGTHS):
    out, i = [], 0
    for ln in lengths:
        scorer.start_video()
        for _ in range(int(ln)):
            s = scorer.push(frames[i], boxes[i])
            if s is not None:
                out.append(s)
            i += 1
        s = scorer.end_video()
        if s is not None:
            out.append(s)
    out.extend(scorer.drain())
    return np.asarray(out, np.float32)


def _pair(tmp_path, flow_nets, seed, **kw):
    jnet, jv, tnet = flow_nets
    mkw = {k: kw.pop(k) for k in ("keys", "grid") if k in kw}
    jmodel, tmodel = _models(tmp_path, seed, **mkw)
    js = JScorer.from_model(jmodel, flow_net=jnet, flow_variables=jv,
                            flow_model_hw=FLOW_HW, **kw)
    ts = TScorer.from_model(tmodel, flow_net=tnet, flow_model_hw=FLOW_HW,
                            device="cpu", **kw)
    return js, ts, tmodel


def test_live_flow_stream_matches_jax(tmp_path, flow_nets, split):
    frames, boxes = split
    js, ts, tmodel = _pair(tmp_path, flow_nets, 1)
    want = _stream(js, frames, boxes)
    got = _stream(ts, frames, boxes)
    assert got.shape == want.shape == (sum(LENGTHS),)
    assert np.isfinite(got).all()
    assert np.ptp(got) > 0.1  # real scores, not a constant
    np.testing.assert_allclose(got, want, **TOL)

    # pipeline_depth shifts emission only: identical scores
    piped = TScorer.from_model(tmodel, flow_net=flow_nets[2],
                               flow_model_hw=FLOW_HW, device="cpu",
                               pipeline_depth=2)
    np.testing.assert_array_equal(_stream(piped, frames, boxes), got)


@pytest.mark.parametrize("use_flow", [True, False])
def test_streaming_scorer_matches_jax(tmp_path, split, use_flow):
    """The base StreamingScorer that live-flow serving builds on: flow
    maps pushed by the caller (frame 3 without one: zero flow cubes, the
    motion filter bypassed) or a raw-only model, with pipeline_depth 1."""
    frames, boxes = split
    jmodel, tmodel = _models(tmp_path, 6, use_flow=use_flow)
    flows = np.random.default_rng(8).normal(
        0, 1.5, frames.shape[:3] + (2,)).astype(np.float32)

    def run(scorer):
        out, i = [], 0
        for ln in LENGTHS:
            scorer.start_video()
            for _ in range(ln):
                flow = flows[i] if use_flow and i != 3 else None
                out.append(scorer.push(frames[i], boxes[i], flow=flow))
                i += 1
        return [s for s in out if s is not None] + scorer.drain()

    want = run(JStreamingScorer.from_model(jmodel, pipeline_depth=1))
    got = run(TStreamingScorer.from_model(tmodel, pipeline_depth=1, device="cpu"))
    assert len(got) == len(want) == sum(LENGTHS)
    np.testing.assert_allclose(got, want, **TOL)


def test_gray_stream_matches_jax(tmp_path, flow_nets, split):
    frames, boxes = split
    gray = frames[..., 0]
    js, ts, _ = _pair(tmp_path, flow_nets, 2, gray_stream=True)
    np.testing.assert_allclose(_stream(ts, gray, boxes),
                               _stream(js, gray, boxes), **TOL)


def test_grid_routing_matches_jax(tmp_path, flow_nets, split):
    """A 2x2 grid with cell (1, 1) untrained: boxes route by route_hw to
    their cells' blocks, and to big_number in the untrained one."""
    frames, boxes = split
    js, ts, _ = _pair(tmp_path, flow_nets, 3,
                      keys=((0, 0, 0), (0, 0, 1), (0, 1, 0)), grid=(2, 2),
                      route_hw=(48, 64))
    got = _stream(ts, frames, boxes)
    np.testing.assert_allclose(got, _stream(js, frames, boxes), **TOL)
    assert len(np.unique(got)) > 3


def test_bf16_flow_compute(tmp_path, flow_nets, split):
    """flow_compute_dtype=bfloat16: the flow net runs on a bf16 copy of
    its weights (the shared f32 net is untouched) and the scores stay
    close to f32 (the JAX package's own bf16 bound)."""
    frames, boxes = split
    _, tmodel = _models(tmp_path, 4)
    tnet = flow_nets[2]
    kw = dict(flow_net=tnet, flow_model_hw=FLOW_HW, device="cpu")
    s32 = _stream(TScorer.from_model(tmodel, **kw), frames, boxes)
    sc16 = TScorer.from_model(tmodel, flow_compute_dtype=torch.bfloat16, **kw)
    assert next(sc16.flow_net.parameters()).dtype == torch.bfloat16
    assert next(tnet.parameters()).dtype == torch.float32
    s16 = _stream(sc16, frames, boxes)
    assert np.isfinite(s16).all()
    np.testing.assert_allclose(s16, s32, rtol=0.1, atol=0.05)


def test_api_discipline(tmp_path, flow_nets, split):
    """push before start_video and start_video over an unflushed video
    raise; raw-only models are refused."""
    import dataclasses

    frames, boxes = split
    _, tmodel = _models(tmp_path, 5)
    sc = TScorer.from_model(tmodel, flow_net=flow_nets[2],
                            flow_model_hw=FLOW_HW, device="cpu")
    with pytest.raises(ValueError):
        sc.push(frames[0], boxes[0])
    sc.start_video()
    sc.push(frames[0], boxes[0])
    assert sc.push(frames[1], boxes[1]) is None  # frame 1 waits for f_2
    with pytest.raises(ValueError):
        sc.start_video()
    assert sc.end_video() is not None
    sc.start_video()
    cfg_raw = tmodel.cfg.replace(
        model=dataclasses.replace(tmodel.cfg.model, use_flow=False)
    )
    with pytest.raises(ValueError, match="two-stream"):
        TScorer(cfg_raw, None, None, flow_net=flow_nets[2],
                blocks={(0, 0, 0): ({}, (0.0, 1.0))}, device="cpu")
