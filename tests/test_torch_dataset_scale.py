"""The main path at dataset scale in the port — bf16 training, the
device-resident extraction, the segmented whole-split scorer and the
memory-budget routing to it, the pixel-level criterion and
the `train --resident` / `test --resident --pixel-criterion` routes —
held against vec_vad_tpu on the same numpy-seeded inputs and weights, at
nf=4, patch 16, batch 16, 2 epochs."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
from vec_vad_torch import cli as t_cli
from vec_vad_torch import config as t_config
from vec_vad_torch import infer as t_infer
from vec_vad_torch import pipeline as t_pipe
from vec_vad_torch import runner as t_runner
from vec_vad_torch.data.synthetic import make_synthetic_dataset
from vec_vad_torch.data.video_index import VideoIndex
from vec_vad_torch.eval import metrics as t_metrics
from vec_vad_torch.models.convert import completion_to_jax
from vec_vad_torch.models.layers import BatchNorm as TBatchNorm
from vec_vad_torch.ops.stc import pad_boxes
from vec_vad_torch.score import scoring as t_scoring
from vec_vad_torch.train.trainer import BlockTrainer
from vec_vad_tpu import config as j_config
from vec_vad_tpu import infer as j_infer
from vec_vad_tpu import pipeline as j_pipe
from vec_vad_tpu import runner as j_runner
from vec_vad_tpu.eval import metrics as j_metrics
from vec_vad_tpu.models.layers import BatchNorm as JBatchNorm
from vec_vad_tpu.score import scoring as j_scoring
from vec_vad_tpu.train.trainer import make_loss_fn

P, NF, BATCH, EPOCHS = 16, 4, 16, 2
DATASET = "ped2npy_dataset_scale"
HW = (48, 64)
LENGTH = 19  # frames a video: 38 a split x 2 boxes = 76 cubes, a partial batch

# bf16 against bf16 across the packages (and against f32): the JAX
# package's own bf16 bounds (tests/test_bf16_training.py:39-41) for the
# training scores, which a whole fit's drift cannot tell from f32's. The
# first batch's loss and the resident scores come from one forward, so
# their bounds sit between the port's bf16 gap to JAX's bf16 (3.0e-4
# relative; 1.4e-3 of scores up to 4.9) and the f32 port's gap to it
# (5.7e-4; 1.6e-2), and each test also holds the f32 path outside them
BF16_LOSS_REL = 4e-4
BF16_SCORE_ATOL = 5e-3
BF16_CORR, BF16_MEAN_RATIO = 0.98, 0.15
# the same weights and frames in the other package or form: within the
# cube extraction's 1-LSB flips (PARITY.md:26)
SCORE_TOL = 2e-4
# run_train -> run_test from the same initial weights, relative to the
# largest |value|, as tests/test_torch_main_path.py bounds it
E2E_REL = 5e-4
AUROC_TOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Module scope, so the module-scoped workspaces run capped too."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _configs(compute_dtype="float32", use_flow=False, motion_thr=0.0, h_block=1):
    """The same configuration in both packages."""
    out = []
    for c in (j_config, t_config):
        out.append(c.PipelineConfig(
            dataset_name=DATASET,
            fore=c.ForegroundConfig(patch_size=P, max_boxes_per_frame=8,
                                    motion_thr=motion_thr, h_block=h_block),
            model=c.CompletionConfig(nf=NF, epochs=EPOCHS, batch_size=BATCH,
                                     context_frame_num=4, context_of_num=0,
                                     use_flow=use_flow, compute_dtype=compute_dtype),
        ))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_trainer(compute_dtype="float32"):
    """One JAX BlockTrainer per compute dtype for the whole file, so its
    compiled steps are reused across tests."""
    return j_pipe.make_trainer(_configs(compute_dtype)[0])


def _jax_init(compute_dtype="float32", seed=0):
    """JAX's init_state(seed) with its (params, batch_stats) as numpy trees
    (taken before a fit, which donates the state's buffers)."""
    st = _jax_trainer(compute_dtype).init_state(seed)
    return st, jax.tree.map(np.asarray, st.params), jax.tree.map(np.asarray, st.batch_stats)


def _cubes(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, P, P, 15), dtype=np.uint8)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


@functools.lru_cache(maxsize=None)
def _world():
    """A seeded synthetic test split: frames, boxes, index, and smooth
    flow maps (in pixels) for the flow stream and the motion filter."""
    ds = make_synthetic_dataset(frames_per_video=LENGTH, n_train_videos=1,
                                n_test_videos=2, frame_h=HW[0], frame_w=HW[1], seed=21)
    idx = VideoIndex(["a", "b"], ds.test_video_lengths)
    frames = ds.test_frames
    d = frames[1:].astype(np.float32) - frames[:-1].astype(np.float32)
    flow = np.zeros(frames.shape[:3] + (2,), np.float32)
    flow[1:, ..., 0] = d.mean(-1) / 8.0
    flow[1:, ..., 1] = -d.mean(-1) / 16.0
    return ds, idx, flow


# ---------------------------------------------------------------------------
# bf16 training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_train_mode_batchnorm_matches_jax(masked):
    """Train-mode BatchNorm on a bf16 input: statistics in bf16, running
    statistics f32, against JAX's at bf16's rounding."""
    rng = np.random.default_rng(5)
    x = rng.normal(0.5, 2.0, (6, 4, 4, 3)).astype(np.float32)  # NHWC
    w = np.array([1, 1, 1, 0, 1, 0], np.float32) if masked else None
    scale = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    bias = rng.normal(0.0, 0.1, 3).astype(np.float32)
    jbn = JBatchNorm()
    bf = jax.numpy.bfloat16
    jy, mut = jbn.apply(
        {"params": {"scale": jax.numpy.asarray(scale, bf), "bias": jax.numpy.asarray(bias, bf)},
         "batch_stats": {"mean": np.zeros(3, np.float32), "var": np.ones(3, np.float32)}},
        jax.numpy.asarray(x, bf), False, None if w is None else jax.numpy.asarray(w),
        mutable=["batch_stats"])
    tbn = TBatchNorm(1, 3, device="cpu")
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
    params = {k: p.to(torch.bfloat16) for k, p in tbn.named_parameters()}
    ty = torch.func.functional_call(
        tbn, params, (torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16), True,
                      None if w is None else torch.from_numpy(w)))
    assert ty.dtype == torch.bfloat16 and tbn.running_var.dtype == torch.float32
    want = np.asarray(jy.astype(np.float32))
    got = ty.detach().float().permute(0, 2, 3, 1).numpy()
    # one bf16 ulp of the largest output, rounding taken in either order
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7 * np.abs(want).max())
    for t, j in ((tbn.running_mean, "mean"), (tbn.running_var, "var")):
        np.testing.assert_allclose(t.numpy(), np.asarray(mut["batch_stats"][j]),
                                   rtol=2.0 ** -7, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _bf16_fits():
    """JAX's and the port's bf16 fit_block from JAX's init_state(0) over
    the same 76 seeded cubes, and the port's bf16 trainer."""
    st, params, stats = _jax_init("bfloat16", 0)
    raw = _cubes(9, 76)
    tt = BlockTrainer(_configs("bfloat16")[1].model, P, device="cpu")
    tb = tt.fit_block(raw, seed=0, init_state=tt.state_from_variables(params, stats))
    jb = _jax_trainer("bfloat16").fit_block(raw, None, seed=0, init_state=st)
    return raw, params, stats, tt, tb, jb


def test_bf16_first_loss_matches_jax():
    """The first scheduled batch's bf16 loss from the same weights: the
    JAX package's make_loss_fn against BlockTrainer.loss, within a bound
    the f32 loss falls outside; the bf16 fit_block's first step is that
    bf16 loss, not the f32 one."""
    raw, params, stats, tt, tb, _ = _bf16_fits()
    jcfg, _ = _configs("bfloat16")
    idx, w = tt._epoch_schedule(raw.shape[0], np.random.default_rng(0))
    x = raw[idx[0]].astype(np.float32) / 255.0
    loss_fn = jax.jit(make_loss_fn(_jax_trainer("bfloat16").net, jcfg.model))
    jl = float(loss_fn(params, stats, x, None, w[0])[0])
    tl = {}
    for dtype in ("bfloat16", "float32"):
        fresh = BlockTrainer(_configs(dtype)[1].model, P, device="cpu")
        fresh.start_fit(fresh.state_from_variables(params, stats))
        with torch.no_grad():
            tl[dtype] = float(fresh.loss(torch.from_numpy(x), None, torch.from_numpy(w[0]),
                                         torch.from_numpy(w[0]))[0])
    assert abs(tl["bfloat16"] - jl) / abs(jl) <= BF16_LOSS_REL, (tl, jl)
    assert abs(tl["float32"] - jl) / abs(jl) > BF16_LOSS_REL, (tl, jl)
    assert np.float32(tb.losses[0]) == np.float32(tl["bfloat16"]), (tb.losses[0], tl)


def test_bf16_fit_block_matches_jax():
    """bf16 fit_block, port against JAX: the training scores' correlation
    and mean ratio within the JAX package's bf16 bounds; master
    parameters and Adam's moments stay f32; losses finite and falling."""
    _, _, _, tt, tb, jb = _bf16_fits()
    a, b = np.asarray(jb.raw_scores), tb.raw_scores
    assert np.isfinite(b).all() and np.isfinite(tb.losses).all()
    assert np.corrcoef(a, b)[0, 1] > BF16_CORR
    assert abs(b.mean() / a.mean() - 1.0) < BF16_MEAN_RATIO
    assert tb.losses[-5:].mean() < tb.losses[:5].mean()
    assert all(p.dtype == torch.float32 for p in tt.net.parameters())
    assert all(v.dtype == torch.float32 for v in tb.state_dict.values())
    moments = [t for s in tt.opt.state.values() for k, t in s.items() if k != "step"]
    assert len(moments) == 2 * len(list(tt.net.parameters()))
    assert all(t.dtype == torch.float32 for t in moments)


def test_bf16_fit_scores_in_f32():
    """The training-score pass after a bf16 fit runs in f32: an f32
    trainer loaded with the fitted state scores the same cubes to the
    same numbers, bit for bit."""
    raw, _, _, _, tb, _ = _bf16_fits()
    f32 = BlockTrainer(_configs("float32")[1].model, P, device="cpu")
    sc, _ = f32.score_block(tb, raw)
    np.testing.assert_array_equal(sc, tb.raw_scores)


def test_bf16_tracks_f32_in_the_port():
    """bf16 against f32 training in the port from the same weights: the
    JAX package's bf16 bounds."""
    raw, params, stats, _, tb, _ = _bf16_fits()
    tt = BlockTrainer(_configs("float32")[1].model, P, device="cpu")
    fb = tt.fit_block(raw, seed=0, init_state=tt.state_from_variables(params, stats))
    a, b = fb.raw_scores, tb.raw_scores
    assert np.corrcoef(a, b)[0, 1] > BF16_CORR
    assert abs(b.mean() / a.mean() - 1.0) < BF16_MEAN_RATIO


# ---------------------------------------------------------------------------
# device-resident extraction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["raw", "flow_motion", "h_block2"])
def test_resident_extraction_matches_jax(case):
    """extract_cube_set_resident, port against JAX (uint8 within one level,
    flow within 1e-5 of its largest, metadata equal) and against the
    port's own extract_cube_set (bit for bit): raw only, with flow and the
    motion filter dropping cubes, and on a 2-row block grid."""
    ds, idx, flow = _world()
    jcfg, tcfg = _configs(use_flow=case == "flow_motion",
                          motion_thr=0.5 if case == "flow_motion" else 0.0,
                          h_block=2 if case == "h_block2" else 1)
    spec = t_config.DATASETS["UCSDped2"]
    spec = dataclasses.replace(spec, frame_h=HW[0], frame_w=HW[1])
    of = flow if case == "flow_motion" else None
    args = (idx, ds.test_frames, ds.test_boxes)
    res = t_pipe.extract_cube_set_resident(tcfg, spec, *args, flow_frames=of, chunk=8,
                                           device="cpu")
    host = t_pipe.extract_cube_set(tcfg, spec, *args, flow_frames=of, chunk=8,
                                   device="cpu")
    jres = j_pipe.extract_cube_set_resident(
        jcfg, dataclasses.replace(j_config.DATASETS["UCSDped2"], frame_h=HW[0],
                                  frame_w=HW[1]),
        *args, flow_frames=of, chunk=8)
    assert isinstance(res.raw, torch.Tensor) and res.raw.dtype == torch.uint8
    n_boxes = sum(len(b) for b in ds.test_boxes)
    if case == "flow_motion":
        assert 0 < res.size < n_boxes  # the motion filter dropped some
    if case == "h_block2":
        assert set(res.cells[:, 0]) == {0, 1}  # both block rows hold cubes
    jraw = np.asarray(jres.raw).astype(np.int16)
    assert np.abs(res.raw.numpy().astype(np.int16) - jraw).max() <= 1
    for k in ("frame_ids", "boxes", "cells", "scenes"):
        np.testing.assert_array_equal(getattr(res, k), getattr(jres, k))
        np.testing.assert_array_equal(getattr(res, k), getattr(host, k))
    np.testing.assert_array_equal(res.raw.numpy(), host.raw)
    if of is None:
        assert res.flow is None and jres.flow is None
    else:
        jf = np.asarray(jres.flow)
        assert np.abs(res.flow.numpy() - jf).max() <= 1e-5 * np.abs(jf).max()
        np.testing.assert_array_equal(res.flow.numpy(), host.flow)


def test_resident_cube_set_trains_and_scores_like_numpy(monkeypatch):
    """train_model and score_cubes over a resident CubeSet (tensors) equal
    the same over its numpy copy, flow and the saveSegNum segment branch
    included; the empty extraction is the numpy CubeSet."""
    ds, idx, flow = _world()
    _, tcfg = _configs(use_flow=True)
    tcfg = tcfg.replace(fore=dataclasses.replace(tcfg.fore, save_seg_num=40))
    spec = dataclasses.replace(t_config.DATASETS["UCSDped2"], frame_h=HW[0], frame_w=HW[1])
    res = t_pipe.extract_cube_set_resident(tcfg, spec, idx, ds.test_frames, ds.test_boxes,
                                           flow_frames=flow, device="cpu")
    host = dataclasses.replace(res, raw=res.raw.numpy(), flow=res.flow.numpy())
    assert res.size > 40  # the block streams a second segment
    trainer = BlockTrainer(tcfg.model, P, device="cpu")
    m_res = t_pipe.train_model(tcfg, res, trainer=trainer, seed=1)
    m_host = t_pipe.train_model(tcfg, host, trainer=trainer, seed=1)
    b_res, b_host = m_res.blocks[(0, 0, 0)], m_host.blocks[(0, 0, 0)]
    np.testing.assert_array_equal(b_res.raw_scores, b_host.raw_scores)
    np.testing.assert_array_equal(b_res.of_scores, b_host.of_scores)
    np.testing.assert_array_equal(t_pipe.score_cubes(m_res, res, trainer=trainer),
                                  t_pipe.score_cubes(m_host, host, trainer=trainer))
    empty = t_pipe.extract_cube_set_resident(
        tcfg, spec, idx, ds.test_frames, [np.zeros((0, 4), np.float32)] * idx.total_frames,
        flow_frames=flow, device="cpu")
    assert isinstance(empty.raw, np.ndarray) and empty.size == 0
    assert empty.flow.shape == (0, P, P, 2)


# ---------------------------------------------------------------------------
# segmented and routed scoring
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _scoring_inputs(use_flow):
    """A block the port trained over the split's own cubes (so the
    z-scores have the training statistics' scale), its weights in both
    packages' layouts (models/convert), and the split's scoring inputs."""
    ds, idx, flow = _world()
    jcfg, tcfg = _configs(use_flow=use_flow, motion_thr=0.5 if use_flow else 0.0)
    spec = dataclasses.replace(t_config.DATASETS["UCSDped2"], frame_h=HW[0], frame_w=HW[1])
    cubes = t_pipe.extract_cube_set(tcfg, spec, idx, ds.test_frames, ds.test_boxes,
                                    flow_frames=flow if use_flow else None, device="cpu")
    tb = BlockTrainer(tcfg.model, P, device="cpu").fit_block(cubes.raw, cubes.flow, seed=3)
    stats = tb.raw_stats + (tb.of_stats if use_flow else (0.0, 1.0))
    params, batch_stats = completion_to_jax(tb.state_dict)
    boxes_pad, valid = pad_boxes(ds.test_boxes, 8)
    kw = dict(windows=idx.context_indices(4, "predict"), boxes_pad=boxes_pad, valid=valid)
    if use_flow:
        kw.update(flow=flow, of_windows=idx.context_indices(0, "predict"))
    variables = {"params": params, "batch_stats": batch_stats}
    return jcfg, tcfg, variables, tb.state_dict, stats, ds.test_frames, kw


class _LazySlices:
    """A stack read only through slices; reading it whole is counted."""

    def __init__(self, arr):
        self._a = arr
        self.shape, self.dtype = arr.shape, arr.dtype
        self.whole_reads = 0

    def __getitem__(self, key):
        return self._a[key]

    def __array__(self, dtype=None, copy=None):
        self.whole_reads += 1
        return self._a


@pytest.mark.parametrize("use_flow", [False, True])
def test_segmented_chunked_and_routed_scoring_match(use_flow):
    """infer_frame_scores_segmented (16-frame segments: boundaries inside
    videos, windows reaching back across them) and infer_frame_scores on
    its one-segment route (the split fits the budget) and on its routed
    path (a 1-byte budget: 32-frame segments) against the port's resident
    scorer and against JAX's segmented form and its chunk path: 2e-4. The
    routed path reads a lazy stack only in slices."""
    jcfg, tcfg, variables, state, stats, frames, kw = _scoring_inputs(use_flow)
    resident = t_infer.infer_frame_scores_resident(tcfg, state, stats, frames,
                                                   cube_batch=16, device="cpu", **kw)
    assert np.isfinite(resident).all() and (resident > -1e5).sum() > 30
    seg = t_infer.infer_frame_scores_segmented(tcfg, state, stats, frames,
                                               segment_frames=16, cube_batch=16,
                                               device="cpu", **kw)
    chunked = t_infer.infer_frame_scores(tcfg, state, stats, frames, chunk=8,
                                         device="cpu", **kw)
    lazy = _LazySlices(frames)
    lazy_kw = dict(kw, flow=_LazySlices(kw["flow"])) if use_flow else kw
    routed = t_infer.infer_frame_scores(tcfg, state, stats, lazy,
                                        device_memory_budget_bytes=1.0, device="cpu",
                                        **lazy_kw)
    assert lazy.whole_reads == 0
    j_seg = j_infer.infer_frame_scores_segmented(jcfg, variables, stats, frames,
                                                 segment_frames=16, cube_batch=16, **kw)
    j_chunked = j_infer.infer_frame_scores(jcfg, variables, stats, frames, chunk=8, **kw)
    for got, want in ((seg, resident), (chunked, resident), (routed, resident),
                      (seg, j_seg), (chunked, j_chunked)):
        np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)


def test_bf16_resident_scoring_matches_jax():
    """infer_frame_scores_resident with compute_dtype bf16 (by name and by
    torch dtype) against JAX's bf16 resident scorer, within a bound the
    f32 scores fall outside, and within bf16's reach of the f32 scores."""
    jcfg, tcfg, variables, state, stats, frames, kw = _scoring_inputs(True)
    got = t_infer.infer_frame_scores_resident(tcfg, state, stats, frames, cube_batch=16,
                                              compute_dtype="bfloat16", device="cpu", **kw)
    again = t_infer.infer_frame_scores_resident(tcfg, state, stats, frames, cube_batch=16,
                                                compute_dtype=torch.bfloat16,
                                                device="cpu", **kw)
    np.testing.assert_array_equal(got, again)
    want = j_infer.infer_frame_scores_resident(jcfg, variables, stats, frames,
                                               cube_batch=16,
                                               compute_dtype=jax.numpy.bfloat16, **kw)
    f32 = t_infer.infer_frame_scores_resident(tcfg, state, stats, frames, cube_batch=16,
                                              device="cpu", **kw)
    scored = f32 > -1e5
    np.testing.assert_array_equal(got > -1e5, scored)
    assert np.abs(got[scored] - want[scored]).max() <= BF16_SCORE_ATOL
    assert np.abs(f32[scored] - want[scored]).max() > BF16_SCORE_ATOL
    assert np.corrcoef(got[scored], f32[scored])[0, 1] > BF16_CORR
    with pytest.raises(ValueError, match="compute dtype"):
        t_infer.infer_frame_scores_resident(tcfg, state, stats, frames,
                                            compute_dtype="float16", device="cpu", **kw)


# ---------------------------------------------------------------------------
# the pixel-level criterion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("on_device", [False, True])
def test_pixel_level_scalars_match_jax(on_device):
    """Both routes of pixel_level_scalars against JAX's same route, exact,
    including the k-rounding case (coverage 0.3 of |GT| = 50: k = 16 from
    the f64 ceil); each route equal to the other."""
    rng = np.random.default_rng(3)
    h, w = 16, 16
    sizes = [50, 90, 100, 10, 30, 60, 120, 200, 0, 0]
    scores = rng.normal(size=(len(sizes), h, w)).astype(np.float32)
    gt = np.zeros((len(sizes), h, w), bool)
    for i, sz in enumerate(sizes):
        gt[i].reshape(-1)[:sz] = True
    for cov in (0.3, 0.4, 0.7, 0.1):
        ts, tl = t_metrics.pixel_level_scalars(scores, gt, cov, on_device=on_device,
                                               device="cpu")
        if not on_device:  # the host route is the default
            np.testing.assert_array_equal(
                t_metrics.pixel_level_scalars(scores, gt, cov)[0], ts)
        js, jl = j_metrics.pixel_level_scalars(scores, gt, cov, device=on_device)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tl, jl)
        other, _ = t_metrics.pixel_level_scalars(scores, gt, cov,
                                                 on_device=not on_device, device="cpu")
        np.testing.assert_array_equal(ts, other)
    path = None
    assert t_metrics.pixel_level_roc(scores, gt, file_path=path) == \
        j_metrics.pixel_level_roc(scores, gt, file_path=path)


def test_splat_score_masks_device_matches_jax():
    """The device splat against JAX's and the host splat, exact: chunks of
    frames, empty frames, degenerate and fractional boxes; and
    pixel_score_masks, the host splat, gives the same masks."""
    rng = np.random.default_rng(4)
    m, n = 90, 23
    scores = rng.normal(0.0, 3.0, m).astype(np.float32)
    fids = rng.integers(0, n - 4, m)
    x0, y0 = rng.uniform(0, 50, (2, m))
    boxes = np.stack([x0, y0, x0 + rng.uniform(0, 14, m), y0 + rng.uniform(0, 14, m)],
                     1).astype(np.float32)
    boxes[:5, 2] = boxes[:5, 0]  # degenerate: an empty splat
    got = t_scoring.splat_score_masks_device(scores, boxes, fids, n, HW, frame_chunk=8,
                                             device="cpu")
    np.testing.assert_array_equal(
        got, j_scoring.splat_score_masks_device(scores, boxes, fids, n, HW, frame_chunk=8))
    np.testing.assert_array_equal(got, t_scoring.splat_score_masks(scores, boxes, fids,
                                                                   n, HW))
    cubes = t_pipe.CubeSet(np.zeros((m, 1)), None, fids, boxes, np.zeros((m, 2), np.int64),
                           np.ones(m, np.int64))
    np.testing.assert_array_equal(
        t_pipe.pixel_score_masks(scores, cubes, n, HW), got)


# ---------------------------------------------------------------------------
# run_train(resident) -> run_test(resident, pixel_criterion) and the CLI
# ---------------------------------------------------------------------------


def _register():
    for c in (j_config, t_config):
        if DATASET not in c.DATASETS:
            c.register_dataset(dataclasses.replace(
                c.DATASETS["UCSDped2"], name=DATASET, file_ext=".npy"))


def _write_workspace(base):
    """Seeded synthetic videos as uint8 .npy frames in the UCSD layout, the
    bbox fixtures, and .bmp pixel GT masks covering each anomalous frame's
    anomalous square (the generator's last box in such a frame)."""
    import cv2

    ds = make_synthetic_dataset(frames_per_video=LENGTH, n_train_videos=2,
                                n_test_videos=2, frame_h=HW[0], frame_w=HW[1], seed=14)
    root = os.path.join(base, "raw_datasets", DATASET)
    for split, frames, boxes in (("Train", ds.train_frames, ds.train_boxes),
                                 ("Test", ds.test_frames, ds.test_boxes)):
        for f in range(frames.shape[0]):
            v, t = divmod(f, LENGTH)
            d = os.path.join(root, split, f"{split}{v + 1:03d}")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"{t:03d}.npy"), frames[f])
            if split == "Test":
                mask = np.zeros(HW, np.uint8)
                if ds.test_labels[f]:
                    x0, y0, x1, y1 = np.round(boxes[f][-1]).astype(int)
                    mask[y0:y1, x0:x1] = 255
                os.makedirs(d + "_gt", exist_ok=True)
                cv2.imwrite(os.path.join(d + "_gt", f"{t:03d}.bmp"), mask)
        fixture = np.empty(len(boxes), dtype=object)
        fixture[:] = boxes
        np.save(os.path.join(root, f"bboxes_{split.lower()}_obj_det_with_motion.npy"),
                fixture, allow_pickle=True)


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    """run_train(resident=True) then run_test(resident=True,
    pixel_criterion=True) in each package over its own copy of one
    workspace, both from JAX's init_state(0)."""
    _register()
    jcfg, tcfg = _configs()
    out = {}
    for name in ("jax", "torch"):
        out[name] = str(tmp_path_factory.mktemp(f"ws_{name}"))
        _write_workspace(out[name])
    _, params, stats = _jax_init("float32", 0)
    mp = pytest.MonkeyPatch()
    mp.setattr(BlockTrainer, "init_state",
               lambda self, seed: self.state_from_variables(params, stats))
    mp.setattr(j_runner, "make_trainer", lambda cfg: _jax_trainer())
    try:
        jm, _ = j_runner.run_train(jcfg, out["jax"], resident=True)
        jres = j_runner.run_test(jcfg, out["jax"], model=jm, resident=True,
                                 pixel_criterion=True)
        tm, tpath = t_runner.run_train(tcfg, out["torch"], resident=True, device="cpu")
        tres = t_runner.run_test(tcfg, out["torch"], resident=True, pixel_criterion=True,
                                 device="cpu")
    finally:
        mp.undo()
    return dict(tcfg=tcfg, base=out, jm=jm, tm=tm, tpath=tpath, jres=jres, tres=tres)


def test_resident_run_train_run_test_pixel_criterion_match_jax(workspaces):
    w = workspaces
    tb, jb = w["tm"].blocks[(0, 0, 0)], w["jm"].blocks[(0, 0, 0)]
    assert tb.raw_scores.shape == jb.raw_scores.shape == (76,)
    assert _rel(tb.raw_scores, jb.raw_scores) <= E2E_REL
    tf, jf = w["tres"]["frame_scores"], w["jres"]["frame_scores"]
    assert tf.shape == jf.shape == (2 * LENGTH,)
    assert _rel(tf, jf) <= E2E_REL, _rel(tf, jf)
    assert abs(w["tres"]["auroc"] - w["jres"]["auroc"]) <= AUROC_TOL
    tp, jp = w["tres"]["pixel_auroc"], w["jres"]["pixel_auroc"]
    assert np.isfinite(tp) and abs(tp - jp) <= AUROC_TOL, (tp, jp)
    # the per-frame pixel scalars behind the pixel ROC, as each package
    # saved them with its curves
    preds = []
    for name in ("torch", "jax"):
        d = os.path.join(w["base"][name], "results", DATASET)
        (f,) = [f for f in os.listdir(d) if f.endswith("_pixel_results.npz")]
        with np.load(os.path.join(d, f)) as z:
            preds.append(z["preds"])
    assert preds[0].shape == (2 * LENGTH,)
    assert _rel(*preds) <= E2E_REL, _rel(*preds)
    # the resident route wrote no cube cache
    assert not any(f.startswith("foreground_") for _, _, fs in
                   os.walk(os.path.join(w["base"]["torch"], "data")) for f in fs)


def test_cli_resident_and_pixel_criterion(workspaces, tmp_path, capsys):
    """`train --resident` and `test --resident --pixel-criterion` with
    --device cpu on a copy of the workspace."""
    import shutil

    base = str(tmp_path / "ws")
    shutil.copytree(os.path.join(workspaces["base"]["torch"], "raw_datasets"),
                    os.path.join(base, "raw_datasets"))
    cfg_path = tmp_path / "config.cfg"
    cfg_path.write_text(
        f"[shared_parameters]\ndataset_name = {DATASET}\n[{DATASET}]\n"
        f"patch_size = {P}\n[SelfComplete]\nnf = {NF}\nepochs = 1\n"
        f"batch_size = {BATCH}\nuseFlow = False\ncontext_of_num = 0\n")
    common = ["--config", str(cfg_path), "--base", base, "--device", "cpu"]
    assert t_cli.main(["train", "--resident", "--log-every", "0"] + common) == 0
    assert t_cli.main(["test", "--resident", "--pixel-criterion"] + common) == 0
    out = capsys.readouterr().out
    assert "trained 1 block model(s)" in out
    assert "pixel-level AUROC (coverage 0.4):" in out and "frame-level AUROC:" in out
