"""The raw-only main path in the port — host layer, train-mode BatchNorm,
the training forward and Adam, BlockTrainer, score_cubes, the resident
scorer, and run_train -> run_test on a synthetic UCSD-layout workspace —
held against vec_vad_tpu on the same numpy-seeded inputs and weights, at
nf=4, patch 16, batch 16, 2 epochs."""

import dataclasses
import functools
import inspect
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from vec_vad_torch import cli as t_cli
from vec_vad_torch import config as t_config
from vec_vad_torch import infer as t_infer
from vec_vad_torch import pipeline as t_pipe
from vec_vad_torch import runner as t_runner
from vec_vad_torch.eval import metrics as t_metrics
from vec_vad_torch.data.video_index import VideoIndex
from vec_vad_torch.fore.detector import PrecomputedDetector as TDetector
from vec_vad_torch.infer import infer_frame_scores_resident as t_resident
from vec_vad_torch.models.convert import completion_from_jax, completion_to_jax
from vec_vad_torch.models.layers import BatchNorm as TBatchNorm
from vec_vad_torch.ops.stc import pad_boxes as t_pad_boxes
from vec_vad_torch.runtime import artifacts as t_art
from vec_vad_torch.score import scoring as t_scoring
from vec_vad_torch.train.trainer import BlockTrainer
from vec_vad_tpu import config as j_config
from vec_vad_tpu import pipeline as j_pipe
from vec_vad_tpu import runner as j_runner
from vec_vad_tpu.eval import metrics as j_metrics
from vec_vad_tpu.fore.detector import PrecomputedDetector as JDetector
from vec_vad_tpu.infer import infer_frame_scores_resident as j_resident
from vec_vad_tpu.models.layers import BatchNorm as JBatchNorm
from vec_vad_tpu.ops.stc import pad_boxes as j_pad_boxes
from vec_vad_tpu.runtime import artifacts as j_art
from vec_vad_tpu.score import scoring as j_scoring
from vec_vad_tpu.train.trainer import make_loss_fn, make_train_step

P, NF, BATCH, EPOCHS = 16, 4, 16, 2
DATASET = "ped2npy_main_path"
HW = (48, 64)
LENGTHS = (19, 19)  # 38 frames x 2 boxes = 76 cubes: a partial final batch


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Module scope, so the module-scoped workspaces run capped too."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(masked_bn=True):
    """The same raw-only configuration in both packages."""
    kw = dict(
        dataset_name=DATASET,
        fore=dict(patch_size=P, max_boxes_per_frame=8),
        model=dict(nf=NF, epochs=EPOCHS, batch_size=BATCH, context_frame_num=4,
                   context_of_num=0, use_flow=False, masked_bn=masked_bn),
    )
    out = []
    for c in (j_config, t_config):
        out.append(c.PipelineConfig(
            dataset_name=kw["dataset_name"],
            fore=c.ForegroundConfig(**kw["fore"]),
            model=c.CompletionConfig(**kw["model"]),
        ))
    return out


def _cubes(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, P, P, 15), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_trainer(masked_bn=True):
    """One JAX BlockTrainer per configuration for the whole file, so its
    compiled steps are reused across tests."""
    return j_pipe.make_trainer(_configs(masked_bn)[0])


def _jax_init(masked_bn=True, seed=0):
    """JAX's BlockTrainer and its init_state(seed), with the state's
    (params, batch_stats) as numpy trees."""
    jt = _jax_trainer(masked_bn)
    st = jt.init_state(seed)
    params = jax.tree.map(np.asarray, st.params)
    stats = jax.tree.map(np.asarray, st.batch_stats)
    return jt, st, params, stats


@functools.lru_cache(maxsize=None)
def _jax_fit(n, masked_bn, seed):
    """JAX's fit_block from its init_state(seed) on n seeded uint8 cubes."""
    jt, st, _, _ = _jax_init(masked_bn, seed)
    return jt.fit_block(_cubes(9, n), None, seed=seed, init_state=st)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# host layer: exactly equal
# ---------------------------------------------------------------------------


def test_scoring_host_functions_equal_jax():
    rng = np.random.default_rng(0)
    m, n = 60, 25
    raw = rng.normal(100.0, 10.0, m).astype(np.float32)
    of = rng.normal(10.0, 1.0, m).astype(np.float32)
    for args in ((raw, None, (99.0, 9.5), None, 1.0, 1.0),
                 (raw, of, (99.0, 9.5), (10.2, 1.1), 0.7, 0.3)):
        np.testing.assert_array_equal(t_scoring.fuse_scores(*args),
                                      j_scoring.fuse_scores(*args))
    fids = rng.integers(0, n - 3, m)
    x0, y0 = rng.uniform(-2, 50, (2, m))
    boxes = np.stack([x0, y0, x0 + rng.uniform(0, 12, m),
                      y0 + rng.uniform(0, 12, m)], 1).astype(np.float32)
    boxes[:4, 2] = boxes[:4, 0]  # degenerate: an empty splat
    for b in (None, boxes):
        np.testing.assert_array_equal(
            t_scoring.frame_scores_from_cubes(raw, fids, n, boxes=b),
            j_scoring.frame_scores_from_cubes(raw, fids, n, boxes=b))
    fs = j_scoring.frame_scores_from_cubes(raw, fids, n, boxes=boxes)
    vids = np.repeat([1, 2, 3], [10, 10, 5])
    np.testing.assert_array_equal(t_scoring.normalize_scores_per_video(fs, vids),
                                  j_scoring.normalize_scores_per_video(fs, vids))
    np.testing.assert_array_equal(
        t_scoring.splat_score_masks(raw, boxes, fids, n, HW),
        j_scoring.splat_score_masks(raw, boxes, fids, n, HW))


def test_metrics_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, 200)
    scores = np.round(rng.normal(size=200) + labels, 1)  # ties collapse
    for name in ("roc_curve", "precision_recall_curve"):
        for g, w in zip(getattr(t_metrics, name)(scores, labels),
                        getattr(j_metrics, name)(scores, labels)):
            np.testing.assert_array_equal(g, w)
    fpr, tpr, thr = t_metrics.roc_curve(scores, labels)
    assert thr[0] == np.inf  # sklearn >= 1.3
    assert t_metrics.auc(fpr, tpr) == j_metrics.auc(fpr, tpr)
    assert t_metrics.roc_auc_score(scores, labels) == j_metrics.roc_auc_score(scores, labels)
    tr, jr = t_metrics.evaluate_scores(scores, labels), j_metrics.evaluate_scores(scores, labels)
    assert (tr.roc_auc, tr.eer1, tr.eer2, tr.pr_auc_norm, tr.pr_auc_anom) == \
        (jr.roc_auc, jr.eer1, jr.eer2, jr.pr_auc_norm, jr.pr_auc_anom)
    assert t_metrics.save_roc_pr_curve_data(scores, labels, str(tmp_path / "t.npz")) == \
        j_metrics.save_roc_pr_curve_data(scores, labels, str(tmp_path / "j.npz"))
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert t.files == j.files
        for k in t.files:
            np.testing.assert_array_equal(t[k], j[k])
    with pytest.raises(ValueError, match="both classes"):
        t_metrics.evaluate_scores(scores, np.zeros(200))


def test_boxes_and_artifacts_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    ragged = [rng.uniform(0, 40, (k, 4)).astype(np.float32) for k in (0, 3, 1, 5)]
    for g, w in zip(t_pad_boxes(ragged, 8), j_pad_boxes(ragged, 8)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="max_boxes"):
        t_pad_boxes(ragged, 4)
    fixture = np.empty(len(ragged), dtype=object)
    fixture[:] = ragged
    np.save(tmp_path / "boxes.npy", fixture, allow_pickle=True)
    td, jd = TDetector(str(tmp_path / "boxes.npy")), JDetector(str(tmp_path / "boxes.npy"))
    assert len(td) == len(jd) == 4
    for i in range(4):
        np.testing.assert_array_equal(td.boxes_for_frame(i), jd.boxes_for_frame(i))

    jcfg, tcfg = _configs()
    parts = (tcfg.fore, 4, "test", rng.normal(size=(3, 4)), [("a", 1, 2.5)])
    assert t_art.fingerprint(*parts) == j_art.fingerprint(jcfg.fore, *parts[1:])
    calls = []
    cache = t_art.ArtifactCache(str(tmp_path / "cache"))
    for _ in range(2):
        got = cache.get_or_compute(
            "stage", "fp0", lambda: calls.append(1) or np.arange(3),
            lambda p, v: np.save(p, v), np.load, ext=".npy")
        np.testing.assert_array_equal(got, np.arange(3))
    assert calls == [1]
    tree = {"a": {"b": np.arange(4.0)}, "c": np.ones(2, np.int32), "d": None}
    t_art.save_pytree_npz(str(tmp_path / "t.npz"), tree, {"k": 1})
    j_art.save_pytree_npz(str(tmp_path / "j.npz"), tree, {"k": 1})
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            np.testing.assert_array_equal(t[k], j[k])


def test_completion_weights_round_trip_bit_for_bit():
    """completion_to_jax inverts completion_from_jax, both ways."""
    jcfg, tcfg = _configs()
    _, _, params, stats = _jax_init(True, seed=3)
    sd = completion_from_jax(params, stats)
    p2, s2 = completion_to_jax(sd)
    assert jax.tree.structure(p2) == jax.tree.structure(params)
    assert jax.tree.structure(s2) == jax.tree.structure(stats)
    for a, b in zip(jax.tree.leaves((p2, s2)), jax.tree.leaves((params, stats))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    trainer = BlockTrainer(tcfg.model, P, device="cpu")
    sd0 = trainer.init_state(5)
    sd1 = completion_from_jax(*completion_to_jax(sd0))
    assert sd1.keys() == sd0.keys()
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k


# ---------------------------------------------------------------------------
# model, training side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_train_mode_batchnorm_matches_jax(masked):
    """Batch statistics over (B, H, W) per channel, the running stats
    updated with momentum 0.1 and the unbiased variance; with a pad mask
    only the weighted rows count. Two members x 3 channels, grouped."""
    rng = np.random.default_rng(4)
    x = rng.normal(0.5, 2.0, (7, 4, 4, 6)).astype(np.float32)  # NHWC
    w = np.array([1, 1, 1, 1, 1, 0, 0], np.float32) if masked else None
    jbn = JBatchNorm()
    v = jbn.init(jax.random.key(0), jnp.asarray(x), False)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                    "bias": rng.normal(size=6).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=6).astype(np.float32),
                         "var": rng.uniform(0.5, 2, 6).astype(np.float32)}}
    y, mut = jbn.apply(v, jnp.asarray(x), False,
                       None if w is None else jnp.asarray(w), mutable=["batch_stats"])
    tbn = TBatchNorm(2, 3, device="cpu")
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        tbn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        tbn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        tbn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    yt = tbn(xt, True, None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), rtol=1e-5)
    if masked:  # the wrap-padded batch trains like the bare partial batch
        bare = TBatchNorm(2, 3, device="cpu")
        bare.load_state_dict({k: v for k, v in tbn.state_dict().items()})
        with torch.no_grad():
            bare.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
            bare.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
        yb = bare(xt[:5], True)
        np.testing.assert_allclose(yb.detach().numpy(), yt[:5].detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bare.running_var.numpy(), tbn.running_var.numpy(),
                                   rtol=1e-5)


def _transplanted(masked_bn, seed=0):
    jcfg, tcfg = _configs(masked_bn)
    jt, st, params, stats = _jax_init(masked_bn, seed)
    tt = BlockTrainer(tcfg.model, P, device="cpu")
    return jcfg, tcfg, jt, st, params, stats, tt


@pytest.mark.parametrize("masked_bn", [False, True])
def test_training_forward_loss_and_grads_match_jax(masked_bn):
    """From transplanted JAX weights, on a wrap-padded batch: the loss
    within 1e-5 relative, every gradient within 1e-4 of its largest
    entry, the updated running statistics within 1e-5."""
    jcfg, tcfg, jt, st, params, stats, tt = _transplanted(masked_bn)
    x = _cubes(6, BATCH).astype(np.float32) / 255.0
    w = np.r_[np.ones(11), np.zeros(BATCH - 11)].astype(np.float32)
    loss_fn = make_loss_fn(jt.net, jcfg.model)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (jloss, (jstats, _, _)), jgrads = grad_fn(
        st.params, st.batch_stats, jnp.asarray(x), None, jnp.asarray(w))
    tt.start_fit(tt.state_from_variables(params, stats))
    wt = torch.from_numpy(w)
    tloss, _, _ = tt.loss(torch.from_numpy(x), None, wt, wt if masked_bn else None)
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = completion_from_jax(jax.tree.map(np.asarray, jgrads), stats)
    # relative to the largest gradient entry of the net: a convolution bias
    # right before a BatchNorm has a gradient of 0 up to rounding
    largest = max(float(np.abs(v.numpy()).max()) for v in want.values()
                  if v.dim())
    for name, p in tt.net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4 * largest, err_msg=name)
    want_stats = completion_from_jax(params, jax.tree.map(np.asarray, jstats))
    for name, b in tt.net.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_stats[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_adam_step_matches_jax():
    """One optax Adam step against one torch Adam step (foreach) from the
    same weights and batch: every weight within 1e-5 of the net's largest
    (BatchNorm's scale, 1). A
    convolution bias right before a BatchNorm has a gradient of 0 up to
    rounding, which Adam's first step scales to up to lr either way: those
    are held to a step of at most lr in both packages instead."""
    jcfg, tcfg, jt, st, params, stats, tt = _transplanted(True)
    x = _cubes(7, BATCH).astype(np.float32) / 255.0
    w = np.ones(BATCH, np.float32)
    step = jax.jit(make_train_step(jt.net, jcfg.model, jt.tx))
    jst, _ = step(st, jnp.asarray(x), jnp.zeros((BATCH, P, P, 2)), jnp.asarray(w))
    tt.start_fit(tt.state_from_variables(params, stats))
    tt.train_step(torch.from_numpy(x), None, torch.from_numpy(w))
    want = completion_from_jax(jax.tree.map(np.asarray, jst.params),
                               jax.tree.map(np.asarray, jst.batch_stats))
    before = completion_from_jax(params, stats)
    lr = tcfg.model.learning_rate
    largest = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for name, t in tt.net.state_dict().items():
        wv = want[name].numpy()
        if name.endswith(("conv0.bias", "conv1.bias")):
            for got in (t.numpy(), wv):
                assert np.abs(got - before[name].numpy()).max() <= lr * (1 + 1e-5)
            continue
        np.testing.assert_allclose(t.numpy(), wv, rtol=0, atol=1e-5 * largest,
                                   err_msg=name)


@pytest.mark.parametrize("n,masked_bn", [(76, True), (11, False)])
def test_fit_block_matches_jax(n, masked_bn):
    """fit_block from JAX's init_state(seed) on the same uint8 cubes: the
    same schedule (76 cubes: 4 full batches and a padded one an epoch; 11:
    a block smaller than one batch), masked_bn both ways, training scores
    within 1e-3 relative (JAX's own whole-pipeline bound is 0.12 %)."""
    jcfg, tcfg, jt, st, params, stats, tt = _transplanted(masked_bn, seed=8)
    raw = _cubes(9, n)
    jb = _jax_fit(n, masked_bn, 8)
    tb = tt.fit_block(raw, None, seed=8,
                      init_state=tt.state_from_variables(params, stats))
    assert tb.of_scores is None and tb.losses.shape == (EPOCHS * -(-n // BATCH),)
    assert np.isfinite(tb.losses).all()
    np.testing.assert_allclose(tb.raw_scores, jb.raw_scores, rtol=1e-3)
    # float cubes: trained on their uint8 levels, scored as given
    tf = tt.fit_block(raw.astype(np.float32) / 255.0, None, seed=8,
                      init_state=tt.state_from_variables(params, stats))
    np.testing.assert_allclose(tf.raw_scores, tb.raw_scores, rtol=1e-6)


def test_train_model_streams_segments_like_jax(monkeypatch):
    """A block larger than save_seg_num streams in segments per epoch
    (train.py:292-296): train_model in both packages from JAX's
    init_state(0) over the same 29 cubes in segments of 16 + 13 (a padded
    batch), the training scores of all 29 within 1e-3 relative; a 1-cube
    block is skipped."""
    jcfg, tcfg = _configs()
    jcfg = jcfg.replace(fore=dataclasses.replace(jcfg.fore, save_seg_num=16))
    tcfg = tcfg.replace(fore=dataclasses.replace(tcfg.fore, save_seg_num=16))
    _, _, params, stats = _jax_init(True, 0)
    monkeypatch.setattr(BlockTrainer, "init_state",
                        lambda self, seed: self.state_from_variables(params, stats))
    cells = np.zeros((30, 2), np.int64)
    cells[29] = (0, 1)  # a block of one cube
    kw = dict(raw=_cubes(15, 30), flow=None, frame_ids=np.arange(30),
              boxes=np.zeros((30, 4), np.float32), cells=cells,
              scenes=np.ones(30, np.int64))
    jm = j_pipe.train_model(jcfg, j_pipe.CubeSet(**kw), trainer=_jax_trainer(True))
    tm = t_pipe.train_model(tcfg, t_pipe.CubeSet(**kw), device="cpu")
    assert sorted(tm.blocks) == sorted(jm.blocks) == [(0, 0, 0)]
    tb, jb = tm.blocks[(0, 0, 0)], jm.blocks[(0, 0, 0)]
    assert tb.losses.shape == (EPOCHS * 2,)  # 1 + 1 batches an epoch
    np.testing.assert_allclose(tb.raw_scores, jb.raw_scores, rtol=1e-3)


# ---------------------------------------------------------------------------
# scoring on the same weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_block():
    """A block JAX trained (2 epochs over 76 cubes), in both packages."""
    jcfg, tcfg = _configs()
    jt, jb = _jax_trainer(True), _jax_fit(76, True, 8)
    params = jax.tree.map(np.asarray, jb.params)
    stats = jax.tree.map(np.asarray, jb.batch_stats)
    tb = t_pipe.TrainedBlock(completion_from_jax(params, stats), jb.raw_scores, None)
    return jcfg, tcfg, jt, jb, tb


def test_score_block_and_score_cubes_match_jax(trained_block):
    jcfg, tcfg, jt, jb, tb = trained_block
    raw = _cubes(11, 37)
    tt = BlockTrainer(tcfg.model, P, device="cpu")
    jr, _ = jt.score_block(jb, raw, None)
    tr, to = tt.score_block(tb, raw, None)
    np.testing.assert_allclose(tr, jr, rtol=1e-5)
    assert not to.any()
    f = raw.astype(np.float32) / 255.0  # float cubes score unscaled
    np.testing.assert_allclose(tt.score_block(tb, f)[0], jt.score_block(jb, f, None)[0],
                               rtol=1e-5)
    # a 2-block grid with one untrained block: big_number there
    rng = np.random.default_rng(12)
    cells = np.zeros((37, 2), np.int64)
    cells[30:, 1] = 1
    kw = dict(raw=raw, flow=None, frame_ids=rng.integers(0, 20, 37),
              boxes=rng.uniform(0, 40, (37, 4)).astype(np.float32), cells=cells,
              scenes=np.ones(37, np.int64))
    jm = j_pipe.VadModel(cfg=jcfg, blocks={(0, 0, 0): jb})
    tm = t_pipe.VadModel(cfg=tcfg, blocks={(0, 0, 0): tb})
    js = j_pipe.score_cubes(jm, j_pipe.CubeSet(**kw), trainer=jt)
    ts = t_pipe.score_cubes(tm, t_pipe.CubeSet(**kw), device="cpu")
    assert ts.dtype == np.float64 and (ts[30:] == 100000.0).all()
    # z-normalised: the raw scores' 1e-5 relative, over the block's std
    mu, sd = tb.raw_stats
    np.testing.assert_array_equal(ts[:30], (tr[:30] - np.float32(mu)) / np.float32(sd))
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5 * np.abs(jr).max() / sd)
    np.testing.assert_array_equal(
        t_pipe.frame_level_scores(js, t_pipe.CubeSet(**kw), 20),
        j_pipe.frame_level_scores(js, j_pipe.CubeSet(**kw), 20))


def test_infer_resident_matches_jax(trained_block):
    """infer_frame_scores_resident against JAX's on the same weights and
    frames: within 2e-4 (PARITY.md:26); with 1-LSB cube flips allowed for
    by the same bound. Padded frames and rows are clamped."""
    jcfg, tcfg, jt, jb, tb = trained_block
    from vec_vad_torch.data.synthetic import make_synthetic_dataset
    from vec_vad_torch.data.video_index import VideoIndex

    ds = make_synthetic_dataset(frames_per_video=13, n_train_videos=1,
                                n_test_videos=2, frame_h=HW[0], frame_w=HW[1], seed=13)
    idx = VideoIndex(["a", "b"], ds.test_video_lengths)
    windows = idx.context_indices(4, "predict")
    boxes_pad, valid = t_pad_boxes(ds.test_boxes, 8)
    mu, sd = tb.raw_stats
    args = ((mu, sd, 0.0, 1.0), ds.test_frames, windows, boxes_pad, valid)
    js = j_resident(jcfg, {"params": jb.params, "batch_stats": jb.batch_stats},
                    *args, chunk=8, cube_batch=16)
    ts = t_resident(tcfg, tb.state_dict, *args, chunk=8, cube_batch=16, device="cpu")
    assert ts.shape == (26,) and ts.dtype == np.float32
    np.testing.assert_allclose(ts, js, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# run_train -> run_test on a synthetic UCSD-layout workspace
# ---------------------------------------------------------------------------


def _register():
    for c in (j_config, t_config):
        if DATASET not in c.DATASETS:
            c.register_dataset(dataclasses.replace(
                c.DATASETS["UCSDped2"], name=DATASET, file_ext=".npy"))


def _write_workspace(base):
    """Seeded synthetic videos as uint8 .npy frames in the UCSD layout,
    .bmp label masks and the bbox fixture files both packages read."""
    import cv2
    from vec_vad_torch.data.synthetic import make_synthetic_dataset

    ds = make_synthetic_dataset(frames_per_video=LENGTHS[0], n_train_videos=2,
                                n_test_videos=2, frame_h=HW[0], frame_w=HW[1],
                                seed=14)
    root = os.path.join(base, "raw_datasets", DATASET)
    for split, frames, boxes in (("Train", ds.train_frames, ds.train_boxes),
                                 ("Test", ds.test_frames, ds.test_boxes)):
        for f in range(frames.shape[0]):
            v, t = divmod(f, LENGTHS[0])
            d = os.path.join(root, split, f"{split}{v + 1:03d}")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"{t:03d}.npy"), frames[f])
            if split == "Test":
                g = d + "_gt"
                os.makedirs(g, exist_ok=True)
                cv2.imwrite(os.path.join(g, f"{t:03d}.bmp"),
                            np.full(HW, 255 * int(ds.test_labels[f]), np.uint8))
        fixture = np.empty(len(boxes), dtype=object)
        fixture[:] = boxes
        np.save(os.path.join(root, f"bboxes_{split.lower()}_obj_det_with_motion.npy"),
                fixture, allow_pickle=True)
    return ds


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    """run_train then run_test in each package over its own copy of one
    workspace, both from JAX's init_state(0) (the port's init_state is
    patched to return its transplant)."""
    _register()
    jcfg, tcfg = _configs()
    out = {}
    for name in ("jax", "torch"):
        base = str(tmp_path_factory.mktemp(f"ws_{name}"))
        _write_workspace(base)
        out[name] = base
    _, _, params, stats = _jax_init(True, 0)
    mp = pytest.MonkeyPatch()
    mp.setattr(BlockTrainer, "init_state",
               lambda self, seed: self.state_from_variables(params, stats))
    mp.setattr(j_runner, "make_trainer", lambda cfg: _jax_trainer(True))
    try:
        jm, jpath = j_runner.run_train(jcfg, out["jax"])
        jres = j_runner.run_test(jcfg, out["jax"], model=jm)
        tm, tpath = t_runner.run_train(tcfg, out["torch"], device="cpu")
        tres = t_runner.run_test(tcfg, out["torch"], per_video_norm=False,
                                 save_masks=True, device="cpu")
    finally:
        mp.undo()
    return dict(jcfg=jcfg, tcfg=tcfg, base=out, jm=jm, tm=tm, jpath=jpath,
                tpath=tpath, jres=jres, tres=tres)


# run_train -> run_test, port against JAX from the same initial weights:
# training scores and frame scores relative to their largest |value|. Two
# epochs of training in another summation order (and the extractions may
# round a cube 1 LSB apart): measured 6.4e-05 and 3.6e-05 on this
# workspace (CPU, both packages); the bound is ~8x the larger.
E2E_REL = 5e-4


def test_run_train_run_test_match_jax(workspaces):
    w = workspaces
    assert os.path.basename(w["tpath"]) == os.path.basename(w["jpath"])
    assert sorted(w["tm"].blocks) == sorted(w["jm"].blocks) == [(0, 0, 0)]
    tb, jb = w["tm"].blocks[(0, 0, 0)], w["jm"].blocks[(0, 0, 0)]
    assert tb.raw_scores.shape == jb.raw_scores.shape == (76,)
    assert _rel(tb.raw_scores, jb.raw_scores) <= E2E_REL
    tf, jf = w["tres"]["frame_scores"], w["jres"]["frame_scores"]
    assert tf.shape == jf.shape == (38,)
    assert _rel(tf, jf) <= E2E_REL, _rel(tf, jf)
    np.testing.assert_array_equal(w["tres"]["labels"], w["jres"]["labels"])
    assert abs(w["tres"]["auroc"] - w["jres"]["auroc"]) <= 0.02
    assert os.path.exists(w["tres"]["results_path"])
    masks = np.load(os.path.join(w["base"]["torch"], "results", DATASET,
                                 "score_masks.npy"))
    assert masks.shape == (38,) + HW
    np.testing.assert_allclose(masks.max(axis=(1, 2)), tf, rtol=1e-6)


def test_saved_models_score_the_same_in_either_package(workspaces):
    """Each package loads the other's .npz and scores its own test split
    with it as it scores its own model: the JAX package's model scored by
    the port, and the port's model scored by JAX."""
    w = workspaces
    jm_in_t = t_art.load_vad_model(w["jpath"])
    tm_in_j = j_art.load_vad_model(w["tpath"])
    assert jm_in_t.cfg == w["tcfg"] and tm_in_j.cfg == w["jcfg"]
    for k in ("raw_scores",):
        np.testing.assert_array_equal(getattr(jm_in_t.blocks[(0, 0, 0)], k),
                                      getattr(w["jm"].blocks[(0, 0, 0)], k))
    t_own = w["tres"]["frame_scores"]
    t_with_j = t_runner.run_test(w["tcfg"], w["base"]["torch"], model=jm_in_t,
                                 device="cpu")["frame_scores"]
    j_with_t = j_runner.run_test(w["jcfg"], w["base"]["jax"], model=tm_in_j)["frame_scores"]
    j_own = w["jres"]["frame_scores"]
    # the same weights in the other package: within the cube extraction's
    # 1-LSB flips (2e-4, PARITY.md:26)
    print("cross", _rel(j_with_t, t_own), _rel(t_with_j, j_own))
    assert _rel(j_with_t, t_own) <= 2e-4, _rel(j_with_t, t_own)
    assert _rel(t_with_j, j_own) <= 2e-4, _rel(t_with_j, j_own)
    # and the port reads back its own file bit for bit
    tm_back = t_art.load_vad_model(w["tpath"])
    for k, v in w["tm"].blocks[(0, 0, 0)].state_dict.items():
        assert torch.equal(tm_back.blocks[(0, 0, 0)].state_dict[k], v), k


def test_port_trained_model_serves_in_the_port(workspaces):
    """The VadModel run_train returns streams through StreamingScorer
    unchanged: its per-frame scores over the test split equal run_test's
    frame scores (within 2e-4, PARITY.md:26)."""
    from vec_vad_torch.serve import StreamingScorer

    w = workspaces
    data = t_runner.load_split(w["tcfg"], w["base"]["torch"], "test")
    scorer = StreamingScorer.from_model(w["tm"], route_hw=HW, device="cpu")
    got, f = [], 0
    for n in data.index.video_lengths:
        scorer.start_video()
        for _ in range(int(n)):
            got.append(scorer.push(np.asarray(data.frames[f]), data.boxes[f]))
            f += 1
    np.testing.assert_allclose(np.asarray(got, np.float64), w["tres"]["frame_scores"],
                               rtol=2e-4, atol=2e-4)


def test_per_video_norm_and_cli_on_the_workspace(workspaces, capsys):
    """`python -m vec_vad_torch test --device cpu` over the trained
    workspace, with --per-video-norm: the JAX package's messages."""
    w = workspaces
    base = w["base"]["torch"]
    ini = os.path.join(base, "config.cfg")
    with open(ini, "w") as f:
        f.write(f"[shared_parameters]\ndataset_name = {DATASET}\n"
                f"[{DATASET}]\npatch_size = {P}\n"
                f"[SelfComplete]\nepochs = {EPOCHS}\nbatch_size = {BATCH}\n"
                f"nf = {NF}\nuseFlow = False\ncontext_of_num = 0\n")
    rc = t_cli.main(["test", "--config", ini, "--base", base,
                     "--per-video-norm", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "frame-level AUROC: " in out and "curves -> " in out
    res = t_runner.run_test(w["tcfg"], base, model=w["tm"], per_video_norm=True,
                            device="cpu")
    want = t_scoring.normalize_scores_per_video(
        w["tres"]["frame_scores"], np.repeat([1, 2], LENGTHS))
    np.testing.assert_allclose(res["frame_scores"], want, rtol=1e-6, atol=1e-6)
    assert f"frame-level AUROC: {res['auroc']:.4f}" in out


# ---------------------------------------------------------------------------
# CLI flags, device rule, refusals
# ---------------------------------------------------------------------------


def test_cli_train_test_flags(monkeypatch):
    """The flags reach run_train/run_test (nothing runs), whose arguments
    are the JAX package's plus `device`."""
    for fn in ("run_train", "run_test"):
        jkw = list(inspect.signature(getattr(j_runner, fn)).parameters)
        assert list(inspect.signature(getattr(t_runner, fn)).parameters) == jkw + ["device"]
    seen = {}

    def fake_train(cfg, base, **kw):
        seen["train"] = (cfg.dataset_name, base, kw)
        return t_pipe.VadModel(cfg=cfg), "m.npz"

    def fake_test(cfg, base, **kw):
        seen["test"] = (cfg.dataset_name, base, kw)
        return {"auroc": 0.5, "results_path": "r"}

    monkeypatch.setattr(t_runner, "run_train", fake_train)
    monkeypatch.setattr(t_runner, "run_test", fake_test)
    assert t_cli.main(["train", "--base", "B", "--dataset", "avenue", "--seed", "3",
                       "--log-every", "0", "--device", "cpu"]) == 0
    assert seen["train"] == ("avenue", "B", dict(seed=3, log_every=0, resident=False,
                                                 device="cpu"))
    assert t_cli.main(["test", "--base", "B", "--save-masks", "--per-video-norm"]) == 0
    assert seen["test"] == ("UCSDped2", "B", dict(
        save_masks=True, per_video_norm=True, pixel_criterion=False,
        resident=False, device="cuda"))


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, tcfg = _configs()
    cubes = t_pipe.CubeSet(_cubes(0, 4), None, np.zeros(4, np.int64),
                           np.zeros((4, 4), np.float32), np.zeros((4, 2), np.int64),
                           np.ones(4, np.int64))
    model = t_pipe.VadModel(cfg=tcfg)
    calls = [
        lambda: t_runner.run_train(tcfg, str(tmp_path)),
        lambda: t_runner.run_test(tcfg, str(tmp_path), model=model),
        lambda: t_pipe.train_model(tcfg, cubes),
        lambda: t_pipe.score_cubes(model, cubes),
        lambda: t_resident(tcfg, {}, (0, 1, 0, 1), np.zeros((1, 8, 8, 3), np.uint8),
                           np.zeros((1, 5), np.int64), np.zeros((1, 8, 4), np.float32),
                           np.zeros((1, 8), bool)),
        lambda: BlockTrainer(tcfg.model, P),
        lambda: t_cli.main(["train", "--base", str(tmp_path)]),
        lambda: t_pipe.extract_cube_set_resident(
            tcfg, tcfg.dataset, VideoIndex(["a"], np.array([1])),
            np.zeros((1, 8, 8, 3), np.uint8), [np.zeros((1, 4), np.float32)]),
        lambda: t_infer.infer_frame_scores_segmented(
            tcfg, {}, (0, 1, 0, 1), np.zeros((1, 8, 8, 3), np.uint8),
            np.zeros((1, 5), np.int64), np.zeros((1, 8, 4), np.float32),
            np.zeros((1, 8), bool)),
        lambda: t_infer.infer_frame_scores(
            tcfg, {}, (0, 1, 0, 1), np.zeros((1, 8, 8, 3), np.uint8),
            np.zeros((1, 5), np.int64), np.zeros((1, 8, 4), np.float32),
            np.zeros((1, 8), bool)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_left_out_routes_refuse_by_name(tmp_path):
    """Nothing the port once left out still refuses by name: a split with
    neither frames nor a bbox fixture raises FileNotFoundError, not a
    refusal. Computing boxes without a bbox fixture (item 4.1), `serve
    --motion` (item 4.3), the appearance detector behind a configured
    `mmdet_checkpoint` (item 4.2), the parallel GridTrainer (item 2.8)
    and the fleets over a device mesh (item 5) are ported
    (tests/test_torch_foreground.py, tests/test_torch_motion_serving.py,
    tests/test_torch_detectors.py, tests/test_torch_grid.py,
    tests/test_torch_mesh_routes.py)."""
    jcfg, tcfg = _configs()
    with pytest.raises(FileNotFoundError):
        t_runner.load_split(tcfg, str(tmp_path), "train", device="cpu")
