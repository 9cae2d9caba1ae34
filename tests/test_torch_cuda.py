"""The port's CUDA kernels on the card, each held against its plain PyTorch
version (which the other test_torch_*.py files hold against vec_vad_tpu).

Every test here needs an NVIDIA GPU and nvcc: a CUDA kernel has no CPU
mode, so on a machine without a card they skip. This file imports torch
and vec_vad_torch only, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from vec_vad_torch import kernels
from vec_vad_torch.cli import make_flow_net
from vec_vad_torch.flow.trainer import FlowTrainer
from vec_vad_torch.models.flownet import make_flownet2
from vec_vad_torch.models.flownet import ops as tops

# f32: one dot of C products summed in another order, scaled by 1/C
F32 = dict(rtol=1e-5, atol=1e-6)
# bf16 out: both sides round one f32 sum, at most one bf16 ulp apart
BF16 = dict(rtol=2.0 ** -7, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels run on the card only")
    return torch.device("cuda")


@pytest.fixture
def full_f32():
    """cuDNN convolutions in full f32 (not TF32) for the test's duration."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_disp,stride", [
    ((1, 48, 64, 256), 20, 2),   # the serving shape
    ((8, 48, 64, 256), 20, 2),   # the training shape (FlowNetC conv3, batch 8)
    ((4, 48, 64, 256), 20, 2),   # calc-flow's f32 batch of 4
    ((2, 13, 30, 48), 20, 2),    # ragged H, C != 256, W not a tile multiple
    ((3, 7, 70, 33), 4, 1),      # small displacement grid, odd C (the general kernel)
    ((1, 5, 9, 20), 20, 2),      # H and W under one displacement span, C = 20
    ((2, 12, 70, 256), 20, 2),   # W not a multiple of any x-tile
    ((1, 48, 64, 4), 20, 2),     # the smallest vector C
    ((2, 13, 30, 33), 20, 2),    # FlowNetC's grid with odd C: the general kernel
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_correlation_kernel_matches_plain(cuda, shape, max_disp, stride, dtype):
    a, b = (torch.from_numpy(x).to(cuda, dtype) for x in _pair(7, shape))
    kernels.reset_launch_counts()
    got = tops.correlation(a, b, max_disp, stride)
    torch.cuda.synchronize()
    assert kernels.launch_counts["correlation"] == 1
    want = tops.correlation_ref(a, b, max_disp, stride)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32 if dtype == torch.float32 else BF16))


@pytest.mark.cuda
def test_correlation_kernel_refuses_what_it_cannot_run(cuda):
    a, b = (torch.from_numpy(x).to(cuda) for x in _pair(8, (1, 8, 8, 16)))
    with pytest.raises(ValueError, match="contiguous"):
        tops.correlation(a.transpose(1, 2), b.transpose(1, 2))
    with pytest.raises(TypeError):
        tops.correlation(a.half(), b.half())
    with pytest.raises(ValueError, match="CUDA device"):
        tops.correlation(a, b.cpu())
    # a correlation that needs a gradient runs its backward on the card
    x = a.clone().requires_grad_(True)
    tops.correlation(x, b).square().sum().backward()
    torch.cuda.synchronize()
    assert x.grad.shape == a.shape and torch.isfinite(x.grad).all()
    g = torch.ones((1, 8, 8, 441), device=cuda)
    with pytest.raises(TypeError):
        tops.correlation_bwd(a, b, g.bfloat16())
    with pytest.raises(ValueError, match="must be"):
        tops.correlation_bwd(a, b, g[..., :440])
    with pytest.raises(ValueError, match="CUDA device"):
        tops.correlation_bwd(a, b, g.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_disp,stride", [
    ((8, 48, 64, 256), 20, 2),   # the training shape (FlowNetC conv3, batch 8)
    ((1, 48, 64, 256), 20, 2),   # FlowNet2 fine-tuning's batch 1
    ((2, 13, 30, 48), 20, 2),    # ragged H, C != 256, W not a tile multiple
    ((3, 7, 70, 33), 4, 1),      # small displacement grid, odd C (scalar loads)
    ((1, 5, 9, 20), 20, 2),      # odd W under one pixel span, displacements wider than the frame
    ((2, 6, 40, 200), 20, 2),    # C above one 128-channel group, not a multiple of it
    ((2, 9, 50, 64), 6, 3),      # stride 3: three residues of x a block, idle warps
    ((1, 5, 37, 8), 10, 10),     # stride 10: residue groups across blocks, n = 3
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_correlation_bwd_kernel_matches_plain(cuda, shape, max_disp, stride, dtype):
    """K2 against correlation_bwd_ref on the same inputs: f32 sums of
    n*n products in the same order, fused multiply-adds against separate
    ones -> a few ulp (F32); bf16 grads round one f32 sum -> one ulp."""
    a, b = (torch.from_numpy(x).to(cuda, dtype) for x in _pair(5, shape))
    n = 2 * max_disp // stride + 1
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=shape[:3] + (n * n,)).astype(np.float32)).to(cuda, dtype)
    kernels.reset_launch_counts()
    got = tops.correlation_bwd(a, b, g, max_disp, stride)
    torch.cuda.synchronize()
    assert kernels.launch_counts["correlation_bwd"] == 1
    want = tops.correlation_bwd_ref(a, b, g, max_disp, stride)
    for x, y in zip(got, want):
        assert x.dtype == dtype and x.shape == a.shape
        torch.testing.assert_close(x.float(), y.float(),
                                   **(F32 if dtype == torch.float32 else BF16))


@pytest.mark.cuda
def test_correlation_function_grads_match_cpu(cuda):
    """The autograd Function on the card (K1 forward, K2 backward, one
    launch each) gives the CPU path's cost volume and gradients."""
    a, b = _pair(7, (2, 13, 30, 48))
    g = np.random.default_rng(8).normal(size=(2, 13, 30, 441)).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda):
        x, y = (torch.from_numpy(v).to(dev).requires_grad_(True) for v in (a, b))
        kernels.reset_launch_counts()
        out = tops.correlation(x, y)
        (out * torch.from_numpy(g).to(dev)).sum().backward()
        grads.append((out.detach().cpu(), x.grad.cpu(), y.grad.cpu()))
    torch.cuda.synchronize()
    assert dict(kernels.launch_counts) == {"correlation": 1, "correlation_bwd": 1}
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, **F32)


@pytest.mark.cuda
def test_flownetc_training_step_matches_cpu(cuda, full_f32):
    """One FlowNetC multi-scale training step on the card (TF32 off) and
    on the CPU from the same seeded weights and batch: the loss within
    1e-4 relative, every parameter's gradient within 1e-3 of that
    tensor's largest |grad| (cuDNN and oneDNN sum ~30 f32 convolutions,
    forward and backward, in other orders; cuDNN's weight gradients use
    atomics), and K1 and K2 launched once each."""
    rng = np.random.default_rng(10)
    pairs = rng.uniform(0, 255, (2, 64, 64, 6)).astype(np.float32)
    target = rng.normal(0, 3, (2, 64, 64, 2)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        tr = FlowTrainer(make_flow_net("FlowNetC", 3, dev), device=dev)
        kernels.reset_launch_counts()
        m = tr.step(pairs, target)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert dict(kernels.launch_counts) == {"correlation": 1,
                                                   "correlation_bwd": 1}
        out[dev] = (float(m["loss"]), {k: p.grad.cpu() for k, p in
                                       tr.net.named_parameters()})
    (loss_c, grads_c), (loss_g, grads_g) = out["cpu"], out["cuda"]
    assert np.isfinite(loss_g)
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    for k, want in grads_c.items():
        err = float((grads_g[k] - want).abs().max())
        assert err <= 1e-3 * float(want.abs().max()), k


@pytest.mark.cuda
def test_flownet2_on_card_matches_cpu(cuda, full_f32):
    """The same seeded FlowNet2 on the card (K1 for its cost volume) and on
    the CPU (the plain version): within 1e-4 of the flow's largest
    magnitude, the bound the CPU tests hold the port to against JAX."""
    x = np.random.default_rng(9).uniform(0, 255, (1, 2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        want = make_flownet2(3, device="cpu")(torch.from_numpy(x)).numpy()
        kernels.reset_launch_counts()
        got = make_flownet2(3, device="cuda")(torch.from_numpy(x).to(cuda))
        torch.cuda.synchronize()
    assert kernels.launch_counts["correlation"] == 1
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 1e-4


@pytest.mark.cuda
def test_fit_block_on_card_matches_cpu(cuda):
    """A tiny raw-only fit_block (nf=4, patch 16, batch 16, 2 epochs over
    40 uint8 cubes, a padded final batch) on the card and on the CPU from
    the same init_state: training scores within 1e-4 relative. fit_block
    turns TF32 off itself."""
    from vec_vad_torch.config import CompletionConfig
    from vec_vad_torch.train.trainer import BlockTrainer

    cfg = CompletionConfig(nf=4, epochs=2, batch_size=16, context_of_num=0,
                           use_flow=False)
    raw = np.random.default_rng(3).integers(0, 256, (40, 16, 16, 15), dtype=np.uint8)
    blocks = [BlockTrainer(cfg, 16, device=d).fit_block(raw, seed=2)
              for d in (cuda, "cpu")]
    card, cpu = (b.raw_scores for b in blocks)
    assert np.isfinite(blocks[0].losses).all()
    np.testing.assert_allclose(card, cpu, rtol=1e-4)


@pytest.mark.cuda
def test_two_stream_fit_block_on_card_matches_cpu(cuda):
    """The same for a 5raw1of block with its float flow cubes: raw and
    flow training scores within 1e-4 relative, card against CPU."""
    from vec_vad_torch.config import CompletionConfig
    from vec_vad_torch.train.trainer import BlockTrainer

    cfg = CompletionConfig(nf=4, epochs=2, batch_size=16, context_of_num=0,
                           use_flow=True)
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, (40, 16, 16, 15), dtype=np.uint8)
    of = rng.normal(0.0, 2.0, (40, 16, 16, 2)).astype(np.float32)
    blocks = [BlockTrainer(cfg, 16, device=d).fit_block(raw, of, seed=2)
              for d in (cuda, "cpu")]
    assert np.isfinite(blocks[0].losses).all()
    for k in ("raw_scores", "of_scores"):
        np.testing.assert_allclose(getattr(blocks[0], k), getattr(blocks[1], k),
                                   rtol=1e-4)


def _split(seed=5):
    """A tiny seeded test split (2 videos of 19 frames at 48x64) with its
    index, padded boxes and smooth flow maps."""
    from vec_vad_torch.data.synthetic import make_synthetic_dataset
    from vec_vad_torch.data.video_index import VideoIndex

    ds = make_synthetic_dataset(frames_per_video=19, n_train_videos=1, n_test_videos=2,
                                frame_h=48, frame_w=64, seed=seed)
    d = ds.test_frames[1:].astype(np.float32) - ds.test_frames[:-1].astype(np.float32)
    flow = np.zeros(ds.test_frames.shape[:3] + (2,), np.float32)
    flow[1:, ..., 0] = d.mean(-1) / 8.0
    return ds, VideoIndex(["a", "b"], ds.test_video_lengths), flow


def _two_stream_cfg(**model):
    import dataclasses

    from vec_vad_torch.config import CompletionConfig, ForegroundConfig, PipelineConfig

    cfg = PipelineConfig(dataset_name="UCSDped2",
                         fore=ForegroundConfig(patch_size=16, max_boxes_per_frame=8),
                         model=CompletionConfig(nf=4, epochs=1, batch_size=16,
                                                context_of_num=0, use_flow=True, **model))
    spec = dataclasses.replace(cfg.dataset, frame_h=48, frame_w=64)
    return cfg, spec


@pytest.mark.cuda
def test_resident_cube_set_stays_on_the_card(cuda, monkeypatch):
    """extract_cube_set_resident's cubes go through train_model and
    score_cubes with no device-to-host copy of a raw or flow cube: every
    way a tensor leaves the card is watched for the call."""
    from vec_vad_torch import pipeline

    ds, idx, flow = _split()
    cfg, spec = _two_stream_cfg()
    cubes = pipeline.extract_cube_set_resident(cfg, spec, idx, ds.test_frames,
                                               ds.test_boxes, flow_frames=flow,
                                               device=cuda)
    assert cubes.raw.is_cuda and cubes.flow.is_cuda and cubes.raw.dtype == torch.uint8
    cube_shapes = {tuple(cubes.raw.shape[1:]), tuple(cubes.flow.shape[1:])}
    left = []

    def watch(name):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, **k):
            dest = k.get("device", a[0] if a else None)
            to_host = name != "to" or (isinstance(dest, (str, torch.device))
                                       and torch.device(dest).type != self.device.type)
            if self.is_cuda and to_host and tuple(self.shape[-3:]) in cube_shapes:
                left.append((name, tuple(self.shape)))
            return orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)

    for name in ("cpu", "to", "numpy", "tolist", "__array__"):
        watch(name)
    model = pipeline.train_model(cfg, cubes, seed=0, device=cuda)
    scores = pipeline.score_cubes(model, cubes, device=cuda)
    monkeypatch.undo()
    assert not left, left
    assert scores.shape == (cubes.size,) and np.isfinite(scores).all()


@pytest.mark.cuda
def test_bf16_training_step_on_card(cuda):
    """A bf16 BlockTrainer on the card: f32 master parameters and Adam
    moments after its steps, finite losses, and its training scores
    tracking the same bf16 fit on the CPU (the JAX package's bf16 bounds:
    correlation > 0.98, mean within 15 %)."""
    from vec_vad_torch.train.trainer import BlockTrainer

    cfg, _ = _two_stream_cfg(compute_dtype="bfloat16")
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 256, (40, 16, 16, 15), dtype=np.uint8)
    of = rng.normal(0.0, 2.0, (40, 16, 16, 2)).astype(np.float32)
    card = BlockTrainer(cfg.model, 16, device=cuda)
    blocks = [t.fit_block(raw, of, seed=2)
              for t in (card, BlockTrainer(cfg.model, 16, device="cpu"))]
    assert np.isfinite(blocks[0].losses).all()
    assert all(p.dtype == torch.float32 and p.is_cuda for p in card.net.parameters())
    assert all(t.dtype == torch.float32 for s in card.opt.state.values()
               for k, t in s.items() if k != "step")
    a, b = blocks[1].raw_scores, blocks[0].raw_scores
    assert np.corrcoef(a, b)[0, 1] > 0.98 and abs(b.mean() / a.mean() - 1.0) < 0.15


@pytest.mark.cuda
def test_segmented_scoring_equals_resident_on_card(cuda):
    """infer_frame_scores_segmented (16-frame segments, boundaries inside
    videos) and infer_frame_scores, on one segment and routed by a 1-byte
    budget to 32-frame segments, against the resident scorer on the
    card, with flow: within 2e-4."""
    from vec_vad_torch import infer
    from vec_vad_torch.models.completion import init_completion_state, make_completion_net
    from vec_vad_torch.ops.stc import pad_boxes

    ds, idx, flow = _split()
    cfg, _ = _two_stream_cfg()
    state = init_completion_state(make_completion_net(cfg.model, "cpu"), seed=4)
    boxes_pad, valid = pad_boxes(ds.test_boxes, 8)
    kw = dict(windows=idx.context_indices(4, "predict"), boxes_pad=boxes_pad, valid=valid,
              flow=flow, of_windows=idx.context_indices(0, "predict"), device=cuda)
    stats = (100.0, 10.0, 5.0, 2.0)
    want = infer.infer_frame_scores_resident(cfg, state, stats, ds.test_frames, **kw)
    seg = infer.infer_frame_scores_segmented(cfg, state, stats, ds.test_frames,
                                             segment_frames=16, **kw)
    whole = infer.infer_frame_scores(cfg, state, stats, ds.test_frames, **kw)
    routed = infer.infer_frame_scores(cfg, state, stats, ds.test_frames,
                                      device_memory_budget_bytes=1.0, **kw)
    assert np.isfinite(want).all() and (want > -1e5).any()
    for got in (seg, whole, routed):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _serving_model(use_flow=True):
    """A seeded 5raw1of (or raw-only) nf=4, patch-16 VadModel, one block."""
    from vec_vad_torch.config import CompletionConfig, ForegroundConfig, PipelineConfig
    from vec_vad_torch.models.completion import init_completion_state, make_completion_net
    from vec_vad_torch.pipeline import TrainedBlock, VadModel

    cfg = PipelineConfig(dataset_name="UCSDped2",
                         fore=ForegroundConfig(patch_size=16, max_boxes_per_frame=8),
                         model=CompletionConfig(nf=4, context_of_num=0, use_flow=use_flow))
    sd = init_completion_state(make_completion_net(cfg.model, "cpu"), seed=3)
    rng = np.random.default_rng(3)
    block = TrainedBlock(sd, rng.normal(100.0, 10.0, 64).astype(np.float32),
                         rng.normal(10.0, 1.0, 64).astype(np.float32) if use_flow else None)
    return VadModel(cfg=cfg, blocks={(0, 0, 0): block})


def _serving_stream(n=12, seed=5):
    ds, _, flow = _split(seed)
    return ds.test_frames[:n], ds.test_boxes[:n], flow[:n]


def _push_all(scorer, frames, boxes, flows):
    scorer.start_video()
    out = [scorer.push(f, b, flow=fl) for f, b, fl in zip(frames, boxes, flows)]
    return np.asarray([s for s in out if s is not None] + scorer.drain())


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# two runs of the same f32 scoring on the card, relative to the largest
# score: cuDNN's default algorithms may sum in another order from one call
# to the next (6.5e-8 seen on an H100, chip_smoke.py RERUN_REL_TOL)
RERUN_REL = 1e-6


@pytest.mark.cuda
def test_serving_push_many_and_pipelining_on_card(cuda):
    """StreamingScorer on the card: push_many in batches of 4 equals 12
    pushes within 2e-4 of the largest score; pipeline_depth 2 equals
    depth 0, and with both TF32 flags on the f32 scores equal the
    flags-off run's (both up to a rerun's last bit) and the flags are on
    again after."""
    from vec_vad_torch.serve import StreamingScorer

    model = _serving_model()
    frames, boxes, flows = _serving_stream()
    want = _push_all(StreamingScorer.from_model(model, device=cuda), frames, boxes, flows)
    sc = StreamingScorer.from_model(model, device=cuda)
    sc.start_video()
    many = sum((sc.push_many(frames[lo:lo + 4], boxes[lo:lo + 4], flows[lo:lo + 4])
                for lo in range(0, 12, 4)), [])
    assert np.isfinite(want).all() and _rel(many, want) <= 2e-4
    piped = StreamingScorer.from_model(model, pipeline_depth=2, device=cuda)
    assert _rel(_push_all(piped, frames, boxes, flows), want) <= RERUN_REL
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = _push_all(StreamingScorer.from_model(model, device=cuda), frames, boxes, flows)
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    assert flags == (True, True)
    assert _rel(on, want) <= RERUN_REL


@pytest.mark.cuda
def test_fleet_tick_matches_single_scorers_on_card(cuda):
    """MultiCameraScorer at C = 3 on the card, camera c starting its video
    at tick c: each camera's scores within 2e-4 of the largest of a
    StreamingScorer on its video."""
    from vec_vad_torch.serve import MultiCameraScorer, StreamingScorer

    model = _serving_model()
    frames, boxes, flows = _serving_stream(16)
    C, n = 3, 8
    feeds = [(frames[4 * c:4 * c + n], boxes[4 * c:4 * c + n], flows[4 * c:4 * c + n])
             for c in range(C)]
    fleet = MultiCameraScorer.from_model(model, n_cameras=C, device=cuda)
    fleet.start_video()
    rows = []
    for t in range(C - 1 + n):
        if t < C:
            fleet.start_video(camera=t)
        j = [min(max(t - c, 0), n - 1) for c in range(C)]
        rows.append(fleet.push_tick(np.stack([feeds[c][0][j[c]] for c in range(C)]),
                                    [feeds[c][1][j[c]] for c in range(C)],
                                    flows=np.stack([feeds[c][2][j[c]] for c in range(C)])))
    rows = np.asarray(rows)
    single = StreamingScorer.from_model(model, device=cuda)
    for c in range(C):
        assert _rel(rows[c:c + n, c], _push_all(single, *feeds[c])) <= 2e-4


@pytest.mark.cuda
def test_live_fleet_launches_k1_once_a_tick(cuda, full_f32):
    """MultiCameraFlowScorer at C = 2 over FlowNet2 on the card: one K1
    launch a live tick (one FlowNet2 forward over both cameras' pairs;
    none at the ring-only second tick) and the tail, and each camera's
    scores within 2e-4 of a FlowStreamingScorer's on its video."""
    from vec_vad_torch.serve import FlowStreamingScorer, MultiCameraFlowScorer

    model = _serving_model()
    frames, boxes, _ = _serving_stream(10)
    net = make_flownet2(0, device=cuda)
    fleet = MultiCameraFlowScorer.from_model(model, n_cameras=2, flow_net=net,
                                             device=cuda)
    feeds = [(frames[:5], boxes[:5]), (frames[5:], boxes[5:])]
    kernels.reset_launch_counts()
    fleet.start_video()
    rows = [fleet.push_tick(np.stack([feeds[0][0][t], feeds[1][0][t]]),
                            [feeds[0][1][t], feeds[1][1][t]]) for t in range(5)]
    rows.append(fleet.end_video())
    assert kernels.launch_counts["correlation"] == 5  # ticks 0, 2, 3, 4 and the tail
    assert rows[1] is None
    rows = np.asarray([r for r in rows if r is not None])
    for c in range(2):
        sc = FlowStreamingScorer.from_model(model, flow_net=net, device=cuda)
        sc.start_video()
        want = [sc.push(f, b) for f, b in zip(*feeds[c])] + [sc.end_video()]
        assert _rel(rows[:, c], np.asarray([s for s in want if s is not None])) <= 2e-4


def _motion_spec(cfg):
    import dataclasses

    return dataclasses.replace(cfg.dataset, frame_h=48, frame_w=64, mt_area_thr=16.0)


def _scored_rel(got, want):
    """_rel over the frames with a scoring box; frames without one
    (-big_number) must match exactly."""
    empty = want <= -1e5
    assert np.array_equal(got[empty], want[empty]) and (~empty).any()
    return _rel(got[~empty], want[~empty])


@pytest.mark.cuda
@pytest.mark.parametrize("k,thr", [(3, 18), (5, 15), (7, 18)])
def test_motion_maps_on_card_equal_cpu(cuda, k, thr):
    """The motion maps on the card equal the CPU's bit for bit: every
    product and partial sum of the blur is exact in f32, and the uint8
    rounding and wraparound are the same ops."""
    from vec_vad_torch.fore.motion import motion_maps

    ds, _, _ = _split()
    f = ds.test_frames
    win = np.stack([f[t:t + 3] for t in range(f.shape[0] - 2)])
    noise = np.random.default_rng(k).integers(0, 256, (4, 3, 48, 64, 3), dtype=np.uint8)
    for w in (win, noise, win[..., :1].copy()):
        cpu = motion_maps(torch.from_numpy(w), k, thr)
        card = motion_maps(torch.from_numpy(w).to(cuda), k, thr)
        assert card.device.type == "cuda" and torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
def test_foreground_boxes_on_card_equal_cpu(cuda):
    """compute_foreground_bboxes (obj_det_with_motion, motion-only) on the
    card equals the CPU run: boxes, order and dtype."""
    from vec_vad_torch.config import PipelineConfig
    from vec_vad_torch.fore.detector import compute_foreground_bboxes

    ds, index, _ = _split()
    cfg = PipelineConfig(dataset_name="UCSDped2")
    out = [compute_foreground_bboxes(cfg, _motion_spec(cfg), index, frames=ds.test_frames,
                                     detector=lambda img: (np.zeros((0, 4)), np.zeros(0)),
                                     chunk=16, device=d) for d in ("cpu", cuda)]
    assert sum(b.shape[0] for b in out[0]) > 0
    for a, b in zip(*out):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_motion_scorers_on_card_match_cpu(cuda):
    """MotionStreamingScorer (streamed flow maps) and
    MotionFlowStreamingScorer (FlowNet2 from seed 0 at a 128x128 model
    size, one K1 launch a scored frame) on the card within 1e-3 of the
    largest score of the same scorer on the CPU."""
    from vec_vad_torch.serve import MotionFlowStreamingScorer, MotionStreamingScorer

    model = _serving_model()
    spec = _motion_spec(model.cfg)
    frames, _, flows = _serving_stream()

    def stream(sc, with_flow):
        sc.start_video()
        out = [sc.push(f, flow=fl) if with_flow else sc.push(f)
               for f, fl in zip(frames, flows)]
        return np.asarray([s for s in out if s is not None] + sc.end_video())

    got, want = (stream(MotionStreamingScorer.from_model(model, spec=spec, device=d), True)
                 for d in (cuda, "cpu"))
    assert want.shape == (12,) and _scored_rel(got, want) <= 1e-3
    kernels.reset_launch_counts()
    got = stream(MotionFlowStreamingScorer.from_model(
        model, spec=spec, flow_net=make_flownet2(0, device=cuda), flow_model_hw=(128, 128),
        device=cuda), False)
    assert kernels.launch_counts["correlation"] == 12
    want = stream(MotionFlowStreamingScorer.from_model(
        model, spec=spec, flow_net=make_flownet2(0, device="cpu"),
        flow_model_hw=(128, 128), device="cpu"), False)
    assert _scored_rel(got, want) <= 1e-3


def _nms_boxes(seed, shape):
    """Boxes (*shape, 4) and scores (*shape) with few score levels (ties),
    repeated boxes and masked (-inf) candidates."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, shape + (2,))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 80, shape + (2,))], -1).astype(np.float32)
    half = shape[-1] // 2
    boxes[..., half:2 * half, :] = boxes[..., :half, :]
    scores = (np.round(rng.uniform(0, 1, shape) * 8) / 8).astype(np.float32)
    scores[rng.uniform(0, 1, shape) < 0.05] = -np.inf
    return torch.from_numpy(boxes), torch.from_numpy(scores)


@pytest.mark.cuda
def test_detector_nms_on_card_equals_cpu(cuda):
    """The detector's greedy NMS sweep and its multiclass step on the card
    equal the CPU's, ties and masked candidates included."""
    from vec_vad_torch.fore import mmdet_detector as det

    boxes, scores = _nms_boxes(0, (2, 5, 400))
    for thr, n_pick in ((0.7, 300), (0.5, 500)):
        got = det.nms_pick(boxes.to(cuda), scores.to(cuda), thr, n_pick)
        want = det.nms_pick(boxes, scores, thr, n_pick)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    boxes, _ = _nms_boxes(1, (2, 300))
    probs = torch.softmax(torch.from_numpy(np.random.default_rng(2).normal(
        0, 3, (2, 300, 81)).astype(np.float32)), -1)
    valid = torch.arange(300)[None].expand(2, 300) < torch.tensor([[250], [300]])
    want = det.multiclass_nms(boxes, probs, valid, 0.05, 0.5, 100)
    got = det.multiclass_nms(boxes.to(cuda), probs.to(cuda), valid.to(cuda), 0.05, 0.5, 100)
    assert want[3].sum() > 20
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_detector_roi_align_pyramid_on_card(cuda):
    """RoIAlign v1, each RoI on its own level, on the card against the CPU
    (the same products summed in the same order: 1e-6)."""
    from vec_vad_torch.fore import mmdet_detector as det

    rng = np.random.default_rng(3)
    pyr = [torch.from_numpy(rng.normal(size=(2, 16, 48 // 2 ** i, 64 // 2 ** i))
                            .astype(np.float32)) for i in range(4)]
    xy = rng.uniform(-10, 250, (2, 40, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + np.exp(rng.uniform(np.log(8), np.log(900), (2, 40, 2)))], -1)
        .astype(np.float32))
    want = det.roi_align_pyramid(pyr, boxes)
    got = det.roi_align_pyramid([p.to(cuda) for p in pyr], boxes.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_detector_preprocess_on_card_equals_cpu(cuda):
    """The cv2-form resize (integer arithmetic) and the normalisation of a
    ShanghaiTech-sized batch on the card equal the CPU's."""
    from vec_vad_torch.fore import mmdet_detector as det

    frames = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 480, 856, 3), dtype=np.uint8))
    want, hw, scale = det.prepare_on_device(frames)
    got, g_hw, g_scale = det.prepare_on_device(frames.to(cuda))
    assert (hw, scale) == (g_hw, g_scale) == ((747, 1333), scale)
    assert tuple(got.shape) == (2, 3, 768, 1344)
    assert torch.equal(det.resize_linear_u8(frames.to(cuda), 747, 1333).cpu(),
                       det.resize_linear_u8(frames, 747, 1333))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_small_detect_on_card_matches_cpu(cuda):
    """A random R50 Cascade R-CNN (random_cascade_state) at 48x64 frames
    with img_scale (133, 80) on the card against the CPU: the pyramid and
    each stage's logits (fed the card's rois) within 1e-4 of the largest,
    the CPU's multiclass NMS on the card's boxes equal to the card's, the
    proposals within 1e-3, and the same detections from the independent
    runs (labels, boxes within 1e-2 px, scores 1e-3)."""
    from vec_vad_torch.fore import mmdet_detector as det
    from vec_vad_torch.fore.mmdet_import import load_mmdet_state

    sd = det.random_cascade_state(50, seed=3)
    cfg = dict(nms_pre=200, nms_post=100, max_num=100, max_per_img=20, img_scale=(133, 80))
    dets = {d: det.MMDetCascadeDetector(load_mmdet_state(det.CascadeRCNN(50), sd),
                                        device=d, **cfg) for d in ("cpu", cuda)}
    frames = np.random.default_rng(5).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    st = {d: {} for d in dets}
    out = {d: dets[d].run(frames, stages=st[d])[0] for d in dets}

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    for a, b in zip(st[cuda]["pyramid"], st["cpu"]["pyramid"]):
        assert rel(a, b) <= 1e-4
    # the RPN's exp in delta2bbox carries the pyramid's ~1e-6 into the
    # proposals (1.1e-4 of the largest coordinate seen on an H100)
    assert rel(st[cuda]["proposals"], st["cpu"]["proposals"]) <= 1e-3
    with torch.no_grad():  # each stage on the CPU from the card's rois
        for i, head in enumerate(dets["cpu"].model.bbox_head):
            logits, _ = head(det.roi_align_pyramid(st["cpu"]["pyramid"][:4],
                                                   st[cuda]["rois"][i].cpu()))
            assert rel(st[cuda]["logits"][i], logits.reshape(st[cuda]["logits"][i].shape)) <= 1e-4
        forced = det.multiclass_nms(st[cuda]["bboxes"].cpu(), st[cuda]["scores"].cpu(),
                                    st[cuda]["valid"].cpu(), 0.05, 0.5, 20)
    for g, w in zip(out[cuda], forced):  # the CPU's NMS on the card's boxes
        assert torch.equal(g.cpu(), w)
    # the independent runs: the three stages carry the proposals' 1e-4
    # into the scores (1.6e-4 relative seen on an H100)
    (gb, gs, gl, gok), (wb, ws, wl, wok) = out[cuda], out["cpu"]
    assert torch.equal(gok.cpu(), wok) and torch.equal(gl.cpu(), wl) and wok.sum() > 0
    torch.testing.assert_close(gs.cpu()[wok], ws[wok], rtol=1e-3, atol=1e-7)
    torch.testing.assert_close(gb.cpu()[wok], wb[wok], rtol=0, atol=1e-2)


def _grid_cfg(use_flow=False):
    from vec_vad_torch.config import CompletionConfig

    return CompletionConfig(nf=4, epochs=2, batch_size=16, context_of_num=0,
                            use_flow=use_flow)


def _grid_data(use_flow, counts=(40, 25, 7, 33)):
    rng = np.random.default_rng(0)
    return [((0, i // 2, i % 2), rng.integers(0, 256, (n, 16, 16, 15), dtype=np.uint8),
             rng.normal(0, 0.1, (n, 16, 16, 2)).astype(np.float32) if use_flow else None)
            for i, n in enumerate(counts)]


@pytest.mark.cuda
@pytest.mark.parametrize("use_flow", [False, True])
def test_grid_matches_sequential_on_card(cuda, full_f32, use_flow):
    """GridTrainer on the card (4 ragged blocks, one ending within the
    others' first epoch) against BlockTrainer.fit_block per block on the
    card from the same init: training scores and losses within 5e-3 of
    their largest. cuDNN sums the folded convolutions (20 groups, not 5)
    in other orders, and training grows that rounding through the
    BatchNorm-preceded biases' Adam steps (chip_smoke.py's GR_REL: the
    folded 5-epoch fit 2.0e-3 of the largest from the sequential one on an
    H100)."""
    from vec_vad_torch.train.grid_trainer import GridTrainer
    from vec_vad_torch.train.trainer import BlockTrainer

    cfg, data = _grid_cfg(use_flow), _grid_data(use_flow)
    grid = GridTrainer(cfg, 16, cuda).fit_blocks(data, seed=3)
    bt = BlockTrainer(cfg, 16, cuda)
    for key, raw, of in data:
        solo = bt.fit_block(raw, of, seed=3)
        g = grid[key]
        for got, want in ((g.raw_scores, solo.raw_scores), (g.losses, solo.losses)) + (
                ((g.of_scores, solo.of_scores),) if use_flow else ()):
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max(), key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_batchnorm_grid_mask_on_card(cuda, full_f32, dtype):
    """BatchNorm with a (G, B) mask on the card against the same layer run
    block by block with each block's (B,) mask: outputs and running
    statistics within rounding (f32 1e-5, bf16 one bf16 ulp of the
    largest output)."""
    from vec_vad_torch.models.layers import BatchNorm

    G, E, F, B = 3, 2, 4, 8
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(1.0, 2.0, (B, G * E * F, 6, 6)).astype(np.float32))
    mask = np.ones((G, B), np.float32)
    mask[0, 5:] = 0
    mask[2, 1:] = 0
    w = torch.from_numpy(mask)
    grid = BatchNorm(G * E, F, device=cuda)
    with torch.no_grad():
        out = grid(x.to(cuda, dtype), True, w.to(cuda))
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for g in range(G):
        one = BatchNorm(E, F, device=cuda)
        c = slice(g * E * F, (g + 1) * E * F)
        with torch.no_grad():
            want = one(x[:, c].to(cuda, dtype), True, w[g].to(cuda))
        got = out[:, c]
        assert float((got - want).abs().max()) <= tol * float(want.abs().max())
        for a, b in ((grid.running_mean[c], one.running_mean),
                     (grid.running_var[c], one.running_var)):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
def test_export_import_round_trip_on_card(cuda, tmp_path):
    """A grid the card trained goes out as the reference's three files and
    comes back through import_model_grid(device='cuda') bit for bit, and
    scores the same on the card."""
    from vec_vad_torch.config import ForegroundConfig, PipelineConfig
    from vec_vad_torch.models.completion_convert import import_model_grid
    from vec_vad_torch.models.completion_export import export_model_grid
    from vec_vad_torch.pipeline import CubeSet, VadModel, score_cubes
    from vec_vad_torch.train.grid_trainer import GridTrainer

    cfg = PipelineConfig(fore=ForegroundConfig(patch_size=16, h_block=2, w_block=2),
                         model=_grid_cfg(True))
    data = _grid_data(True)
    model = VadModel(cfg=cfg, blocks=GridTrainer(cfg.model, 16, cuda).fit_blocks(data))
    export_model_grid(model, str(tmp_path), device=cuda)
    back = import_model_grid(cfg, str(tmp_path), device=cuda)
    assert sorted(back.blocks) == sorted(model.blocks)
    for key, blk in model.blocks.items():
        for k, v in blk.state_dict.items():
            assert torch.equal(back.blocks[key].state_dict[k].cpu(), v.cpu()), k
        np.testing.assert_array_equal(back.blocks[key].of_scores, blk.of_scores)
    raw = np.concatenate([r for _, r, _ in data])
    cells = np.concatenate([np.tile(k[1:], (r.shape[0], 1)) for k, r, _ in data])
    cubes = CubeSet(raw, np.concatenate([o for _, _, o in data]), np.arange(raw.shape[0]),
                    np.zeros((raw.shape[0], 4), np.float32), cells,
                    np.ones(raw.shape[0], np.int64))
    a, b = score_cubes(model, cubes, device=cuda), score_cubes(back, cubes, device=cuda)
    assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()


@pytest.mark.cuda
def test_native_decoder_on_the_card_machine(cuda, tmp_path):
    """The frame decoder where the card is: with libjpeg/libpng/libtiff
    present it decodes the committed fixtures to cv2's arrays
    (decoded.npz); without them its build fails, and make_frame_stack
    raises with the compiler's log rather than fall back to anything."""
    from pathlib import Path

    from vec_vad_torch.data.video_index import VideoIndex
    from vec_vad_torch.runtime import native_loader as nl

    fixtures = Path(__file__).resolve().parent / "data" / "frames"
    paths = sorted(str(p) for p in fixtures.iterdir() if p.suffix in (".jpg", ".png", ".tif"))
    stored = np.load(fixtures / "decoded.npz")
    try:
        nl.build_native()
    except nl.NativeBuildError as e:
        assert any(h in str(e) for h in ("jpeglib.h", "png.h", "tiffio.h", "libjpeg",
                                         "libpng", "libtiff")), str(e)[-2000:]
        with pytest.raises(nl.NativeBuildError):
            nl.make_frame_stack(VideoIndex(["v"], [1], paths[:1]))
        return
    for p in paths:
        want = stored[Path(p).name]
        got = nl.NativePool(4).decode_batch([p], *want.shape[:2])[0]
        np.testing.assert_array_equal(got, want, err_msg=p)


def _random_bn_stats_(net, seed):
    """Seeded BatchNorm affine and running statistics for a with_bn net."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _, m in sorted(net.named_modules(), key=lambda kv: kv[0]):
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                for t, v in ((m.weight, rng.uniform(0.5, 1.5, n)), (m.bias, rng.normal(0, 0.1, n)),
                             (m.running_mean, rng.normal(0, 0.5, n)),
                             (m.running_var, rng.uniform(0.5, 2.0, n))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    return net


@pytest.mark.cuda
def test_with_bn_flownetc_on_card_matches_cpu(cuda, full_f32):
    """A seeded FlowNetC(with_bn=True) on the card (K1, once a forward) and
    on the CPU: eval-mode flow within 1e-4 of its largest |value|, one
    train-mode forward's flow within 1e-4 and its updated running
    statistics within 1e-5 of each tensor's largest."""
    from vec_vad_torch.models.flownet import init_flownet_
    from vec_vad_torch.models.flownet.nets import FlowNetC

    x = np.random.default_rng(12).normal(size=(4, 128, 128, 6)).astype(np.float32)
    nets, outs = {}, {}
    for dev in ("cpu", "cuda"):
        net = _random_bn_stats_(init_flownet_(FlowNetC(True, device=dev), 4), 5)
        xt = torch.from_numpy(x).to(dev)
        kernels.reset_launch_counts()
        with torch.no_grad():
            outs[dev] = [net(xt, False)[0].cpu(), net(xt, True)[0].cpu()]
        if dev == "cuda":
            torch.cuda.synchronize()
            assert kernels.launch_counts["correlation"] == 2
        nets[dev] = net
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    sd_c, sd_g = nets["cpu"].state_dict(), nets["cuda"].state_dict()
    for k in sd_c:
        if "running" in k:
            want, got = sd_c[k], sd_g[k].cpu()
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), k


@pytest.mark.cuda
def test_layer_profiler_on_card(cuda):
    """The layer profiler's probes on the card at small sizes: positive
    times from CUDA events, TF32 left as the caller had it, and the
    ensemble layouts computing the same convolutions."""
    from vec_vad_torch.runtime import layer_profile as lp

    prev = torch.backends.cudnn.allow_tf32
    table = lp.profile_unet_convs(batch=8, iters=2, shapes=lp.UNET_CONV_SHAPES[:2],
                                  device=cuda)
    assert all(ms > 0 for row in table.values() for ms, _ in row.values())
    assert torch.backends.cudnn.allow_tf32 == prev
    res = lp.profile_ensemble_formulations(batch=8, iters=2, device=cuda)
    assert set(res) == {"vmap", "grouped", "blockdiag", "sharedw_batch"}
    out = lp.ensemble_formulation_outputs(batch=8, device=cuda)
    ref = out["vmap"]
    for name in ("grouped", "blockdiag"):
        assert float((out[name] - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    prog = lp.profile_completion_program(batches=(8,), mode="fwd", iters=2, device=cuda)
    assert set(prog) == {"fwd_b8_float32", "fwd_b8_bfloat16"}


# ---------------------------------------------------------------------------
# the device mesh: a mesh that names the card twice (the one-card machine's
# only mesh; NCCL and torch.cuda.comm refuse it, the port's copies do not)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_trainer_on_repeated_card_mesh_matches_one_card(cuda, dtype):
    """fit_block on ["cuda:0", "cuda:0"] (two replicas, their forwards in
    lockstep threads that exchange BatchNorm statistics, one backward a
    step) against the one-card fit from the same init_state: f32 losses
    within 1e-5 relative and training scores within 1e-3 (bf16: the first
    loss within 4e-4, tests/test_torch_dataset_scale.py's bound, and the
    scores' mean ratio within 0.15)."""
    from vec_vad_torch.config import CompletionConfig
    from vec_vad_torch.train.trainer import BlockTrainer

    cfg = CompletionConfig(nf=4, epochs=2, batch_size=16, context_of_num=0,
                           use_flow=False, compute_dtype=dtype)
    raw = np.random.default_rng(3).integers(0, 256, (40, 16, 16, 15), dtype=np.uint8)
    mesh_t = BlockTrainer(cfg, 16, mesh=["cuda:0", "cuda:0"])
    one_t = BlockTrainer(cfg, 16, device=cuda)
    init = one_t.init_state(2)
    got, want = (t.fit_block(raw, seed=2, init_state=init) for t in (mesh_t, one_t))
    assert len(mesh_t._replicas) == 2 and np.isfinite(got.losses).all()
    if dtype == "float32":
        np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
        scale = np.max(np.abs(want.raw_scores))
        assert np.max(np.abs(got.raw_scores - want.raw_scores)) <= 1e-3 * scale
    else:
        assert abs(got.losses[0] - want.losses[0]) <= 4e-4 * abs(want.losses[0])
        assert abs(got.raw_scores.mean() / want.raw_scores.mean() - 1.0) < 0.15


@pytest.mark.cuda
def test_flow_trainer_on_repeated_card_mesh_matches_one_card(cuda, full_f32):
    """Two FlowNetC steps at batch 3 on ["cuda:0", "cuda:0"] (padded to 4,
    2 rows a replica, K1 and K2 launched in each replica) against the
    one-card trainer from the same seeded weights: losses within 1e-5
    relative and every weight within 4e-4, twice Adam's step (lr 1e-4)
    a step: cuDNN's weight gradients sum with atomics, so a gradient near
    0 may round to either sign, and Adam moves it by lr either way."""
    rng = np.random.default_rng(11)
    batches = [(rng.uniform(0, 255, (3, 64, 64, 6)).astype(np.float32),
                rng.normal(0, 3, (3, 64, 64, 2)).astype(np.float32)) for _ in range(2)]
    mesh_t = FlowTrainer(make_flow_net("FlowNetC", 3, "cuda"), mesh=["cuda:0", "cuda:0"])
    one_t = FlowTrainer(make_flow_net("FlowNetC", 3, "cuda"), device=cuda)
    for pairs, target in batches:
        kernels.reset_launch_counts()
        got = mesh_t.step(pairs, target)
        torch.cuda.synchronize()
        assert dict(kernels.launch_counts) == {"correlation": 2, "correlation_bwd": 2}
        want = one_t.step(pairs, target)
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
    for (k, a), b in zip(mesh_t.net.named_parameters(), one_t.net.parameters()):
        assert float((a - b).detach().abs().max()) <= 4e-4, k
