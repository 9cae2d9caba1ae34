"""The two-stream main path in the port — BlockTrainer's second stream,
score_cubes' fusion, the resident scorer with flow and its motion filter,
run_train -> run_test over a flow tree, the cube cache's flow key and
serving a port-trained 5raw1of model — held against vec_vad_tpu on the
same numpy-seeded inputs and weights, at nf=4, patch 16, batch 16, 2
epochs, lambda_of = 0.5 (so a swapped loss weight shows)."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from vec_vad_torch import cli as t_cli
from vec_vad_torch import config as t_config
from vec_vad_torch import pipeline as t_pipe
from vec_vad_torch import runner as t_runner
from vec_vad_torch.infer import infer_frame_scores_resident as t_resident
from vec_vad_torch.models.convert import completion_from_jax
from vec_vad_torch.ops.stc import pad_boxes as t_pad_boxes
from vec_vad_torch.runtime import artifacts as t_art
from vec_vad_torch.score import scoring as t_scoring
from vec_vad_torch.train.trainer import BlockTrainer
from vec_vad_tpu import config as j_config
from vec_vad_tpu import pipeline as j_pipe
from vec_vad_tpu import runner as j_runner
from vec_vad_tpu.infer import infer_frame_scores_resident as j_resident
from vec_vad_tpu.runtime import artifacts as j_art
from vec_vad_tpu.train.trainer import make_loss_fn

P, NF, BATCH, EPOCHS, LAMBDA_OF = 16, 4, 16, 2, 0.5
DATASET = "ped2npy_two_stream"
HW = (48, 64)
LENGTHS = (19, 19)  # 38 frames x 2 boxes = 76 cubes: a partial final batch
N_FIT = 76

# run_train -> run_test, port against JAX from the same initial weights:
# training scores and frame scores relative to their largest |value|, the
# bound tests/test_torch_main_path.py holds the raw-only path to
E2E_REL = 5e-4
# the same weights in the other package: within the cube extraction's
# 1-LSB flips (PARITY.md:26)
CROSS_REL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Module scope, so the module-scoped workspaces run capped too."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _configs(context_of_num=0):
    """The same two-stream configuration in both packages: 5raw1of
    (context_of_num 0) or 5raw5of (4)."""
    out = []
    for c in (j_config, t_config):
        out.append(c.PipelineConfig(
            dataset_name=DATASET,
            fore=c.ForegroundConfig(patch_size=P, max_boxes_per_frame=8),
            model=c.CompletionConfig(nf=NF, epochs=EPOCHS, batch_size=BATCH,
                                     context_frame_num=4,
                                     context_of_num=context_of_num,
                                     use_flow=True, lambda_of=LAMBDA_OF),
        ))
    return tuple(out)


def _cubes(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, P, P, 15), dtype=np.uint8)


def _flow_cubes(seed, n, context_of_num=0):
    """Unscaled float32 flow cubes (flow in pixels, as calc-flow writes)."""
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 2.0, (n, P, P, 2 * (context_of_num + 1))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_trainer(context_of_num=0):
    """One JAX BlockTrainer per configuration for the whole file, so its
    compiled steps are reused across tests."""
    return j_pipe.make_trainer(_configs(context_of_num)[0])


def _jax_init(context_of_num=0, seed=0):
    jt = _jax_trainer(context_of_num)
    st = jt.init_state(seed)
    return (jt, st, jax.tree.map(np.asarray, st.params),
            jax.tree.map(np.asarray, st.batch_stats))


@functools.lru_cache(maxsize=None)
def _jax_fit(with_flow: bool, seed: int = 8):
    """JAX's fit_block from its init_state(seed) over N_FIT seeded cubes,
    with their flow cubes or without."""
    jt, st, _, _ = _jax_init(0, seed)
    of = _flow_cubes(10, N_FIT) if with_flow else None
    return jt.fit_block(_cubes(9, N_FIT), of, seed=seed, init_state=st)


def _port_trainer(context_of_num=0, seed=0):
    """The port's BlockTrainer and JAX's init_state(seed) as its state."""
    _, _, params, stats = _jax_init(context_of_num, seed)
    tt = BlockTrainer(_configs(context_of_num)[1].model, P, device="cpu")
    return tt, tt.state_from_variables(params, stats)


def _as_port_block(jb):
    return t_pipe.TrainedBlock(
        completion_from_jax(jax.tree.map(np.asarray, jb.params),
                            jax.tree.map(np.asarray, jb.batch_stats)),
        jb.raw_scores, jb.of_scores)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# BlockTrainer's second stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("context_of_num", [0, 4])
def test_two_stream_loss_and_grads_match_jax(context_of_num):
    """The training forward from transplanted JAX weights on a wrap-padded
    batch, 5raw1of and 5raw5of: the total loss, loss_raw and loss_of within
    1e-5 relative, every gradient (the flow UNet's too) within 1e-4 of the
    net's largest entry, the running statistics within 1e-5."""
    jcfg, tcfg = _configs(context_of_num)
    jt, st, params, stats = _jax_init(context_of_num)
    tt, state = _port_trainer(context_of_num)
    assert tt.net.of_unets is not None
    x = _cubes(6, BATCH).astype(np.float32) / 255.0
    x_of = _flow_cubes(7, BATCH, context_of_num)
    w = np.r_[np.ones(11), np.zeros(BATCH - 11)].astype(np.float32)
    grad_fn = jax.jit(jax.value_and_grad(make_loss_fn(jt.net, jcfg.model), has_aux=True))
    (jloss, (jstats, jraw, jof)), jgrads = grad_fn(
        st.params, st.batch_stats, jnp.asarray(x), jnp.asarray(x_of), jnp.asarray(w))
    tt.start_fit(state)
    wt = torch.from_numpy(w)
    tloss, traw, tof = tt.loss(torch.from_numpy(x), torch.from_numpy(x_of), wt, wt)
    tloss.backward()
    assert float(jof) > 0.0
    for got, want in ((tloss, jloss), (traw, jraw), (tof, jof)):
        assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    # the weights: a swapped or missing lambda moves the total off
    total = float(traw.detach() + LAMBDA_OF * tof.detach())
    assert abs(float(tloss.detach()) - total) <= 1e-6 * total
    want = completion_from_jax(jax.tree.map(np.asarray, jgrads), stats)
    largest = max(float(np.abs(v.numpy()).max()) for v in want.values() if v.dim())
    assert any(n.startswith("of_unets") for n, _ in tt.net.named_parameters())
    for name, p in tt.net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4 * largest, err_msg=name)
    want_stats = completion_from_jax(params, jax.tree.map(np.asarray, jstats))
    for name, b in tt.net.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_stats[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_fit_block_two_stream_matches_jax(capsys):
    """fit_block from JAX's init_state(8) on the same 76 uint8 cubes and
    their unscaled float flow cubes (4 full batches and a padded one an
    epoch): raw and flow training scores within 1e-3 relative (the
    raw-only bound); the log prints the real flow loss."""
    tt, state = _port_trainer(0, seed=8)
    jb = _jax_fit(True)
    raw, of = _cubes(9, N_FIT), _flow_cubes(10, N_FIT)
    tb = tt.fit_block(raw, of, seed=8, log_every=1, init_state=state)
    assert tb.losses.shape == (EPOCHS * 5,) and np.isfinite(tb.losses).all()
    assert jb.of_scores is not None and tb.of_scores is not None
    np.testing.assert_allclose(tb.raw_scores, jb.raw_scores, rtol=1e-3)
    np.testing.assert_allclose(tb.of_scores, jb.of_scores, rtol=1e-3)
    logged = [line.split() for line in capsys.readouterr().out.splitlines()
              if line.startswith("step ")]
    assert len(logged) == EPOCHS * 5
    assert all(float(f[-1]) > 0.0 and f[-2] == "of" for f in logged)


def test_fit_block_without_flow_inputs_matches_jax():
    """use_flow=True with of_inputs None: like the JAX package, the flow
    head trains and scores against zero targets and of_scores is None.
    The raw training scores within 1e-3 relative; the trained flow head's
    scores on zero targets within 5e-3: a head trained toward zero shrinks
    its outputs (its loss falls 0.154 -> 0.098 in 10 steps), so its scores
    are residuals on which the packages' per-step rounding drift (1e-5 a
    step) weighs more (1.85e-3 measured on the CPU)."""
    tt, state = _port_trainer(0, seed=8)
    jt = _jax_trainer(0)
    jb = _jax_fit(False)
    raw = _cubes(9, N_FIT)
    tb = tt.fit_block(raw, None, seed=8, init_state=state)
    assert jb.of_scores is None and tb.of_scores is None
    np.testing.assert_allclose(tb.raw_scores, jb.raw_scores, rtol=1e-3)
    jr, jo = jt.score_block(jb, raw, None)
    tr, to = tt.score_block(tb, raw, None)
    assert (jo > 0).all()
    np.testing.assert_allclose(tr, jr, rtol=1e-3)
    np.testing.assert_allclose(to, jo, rtol=5e-3)
    # against zero targets: the same scores as zero flow cubes given
    np.testing.assert_array_equal(tt.score_block(tb, raw, np.zeros((N_FIT, P, P, 2),
                                                                   np.float32))[1], to)


def test_fit_block_without_a_flow_head_matches_jax():
    """use_flow=True where no flow head fires (raw_range 0: the flow slot
    sits at the last position): raw-only training, flow scores all 0, and
    of_scores kept as JAX keeps them. The raw training scores within 5e-3
    relative: one member over 20 cubes, whose 2 epochs drift with the
    summation order (4.1e-4 with torch's default threads, 1.5e-3 with this
    file's 2, on the CPU; use_flow=False drifts the same)."""
    jcfg, tcfg = (c.replace(model=dataclasses.replace(c.model, raw_range=0))
                  for c in _configs(0))
    jt = j_pipe.make_trainer(jcfg)
    tt = BlockTrainer(tcfg.model, P, device="cpu")
    assert tt.net.of_unets is None
    st = jt.init_state(3)
    state = tt.state_from_variables(jax.tree.map(np.asarray, st.params),
                                    jax.tree.map(np.asarray, st.batch_stats))
    raw, of = _cubes(4, 20), _flow_cubes(5, 20)
    jb = jt.fit_block(raw, of, seed=3, init_state=st)
    tb = tt.fit_block(raw, of, seed=3, init_state=state)
    np.testing.assert_allclose(tb.raw_scores, jb.raw_scores, rtol=5e-3)
    np.testing.assert_array_equal(tb.of_scores, jb.of_scores)
    assert not tb.of_scores.any()


def test_train_model_streams_flow_segments_like_jax(monkeypatch):
    """A two-stream block larger than save_seg_num streams (raw, of)
    segments per epoch (train.py:292-296): 29 cubes in segments of 16 +
    13, raw and flow training scores within 1e-3 relative."""
    jcfg, tcfg = (c.replace(fore=dataclasses.replace(c.fore, save_seg_num=16))
                  for c in _configs(0))
    _, _, params, stats = _jax_init(0, 0)
    monkeypatch.setattr(BlockTrainer, "init_state",
                        lambda self, seed: self.state_from_variables(params, stats))
    kw = dict(raw=_cubes(15, 29), flow=_flow_cubes(16, 29), frame_ids=np.arange(29),
              boxes=np.zeros((29, 4), np.float32), cells=np.zeros((29, 2), np.int64),
              scenes=np.ones(29, np.int64))
    jm = j_pipe.train_model(jcfg, j_pipe.CubeSet(**kw), trainer=_jax_trainer(0))
    tm = t_pipe.train_model(tcfg, t_pipe.CubeSet(**kw), device="cpu")
    tb, jb = tm.blocks[(0, 0, 0)], jm.blocks[(0, 0, 0)]
    np.testing.assert_allclose(tb.raw_scores, jb.raw_scores, rtol=1e-3)
    np.testing.assert_allclose(tb.of_scores, jb.of_scores, rtol=1e-3)


# ---------------------------------------------------------------------------
# scoring on the same weights
# ---------------------------------------------------------------------------


def test_score_cubes_two_stream_matches_jax():
    """A JAX-trained two-stream block in both packages: (raw, of) scores
    within 1e-5 relative and the fused cube scores within the error that
    bound puts on w_raw * z(raw) + w_of * z(of). A second cell no block
    was trained for scores big_number; a test split without flow scores
    the flow head against zero targets and still fuses (block.of_scores
    is set)."""
    jcfg, tcfg = _configs(0)
    jt, jb = _jax_trainer(0), _jax_fit(True)
    tb = _as_port_block(jb)
    tt = BlockTrainer(tcfg.model, P, device="cpu")
    raw, of = _cubes(11, 37), _flow_cubes(12, 37)
    jr, jo = jt.score_block(jb, raw, of)
    tr, to = tt.score_block(tb, raw, of)
    np.testing.assert_allclose(tr, jr, rtol=1e-5)
    np.testing.assert_allclose(to, jo, rtol=1e-5)
    rng = np.random.default_rng(13)
    cells = np.zeros((37, 2), np.int64)
    cells[30:, 1] = 1
    (mu_r, sd_r), (mu_o, sd_o) = tb.raw_stats, tb.of_stats
    jm = j_pipe.VadModel(cfg=jcfg, blocks={(0, 0, 0): jb})
    tm = t_pipe.VadModel(cfg=tcfg, blocks={(0, 0, 0): tb})
    for flow in (of, None):
        kw = dict(raw=raw, flow=flow, frame_ids=rng.integers(0, 20, 37),
                  boxes=rng.uniform(0, 40, (37, 4)).astype(np.float32), cells=cells,
                  scenes=np.ones(37, np.int64))
        js = j_pipe.score_cubes(jm, j_pipe.CubeSet(**kw), trainer=jt)
        ts = t_pipe.score_cubes(tm, t_pipe.CubeSet(**kw), device="cpu")
        assert (ts[30:] == 100000.0).all() and (js[30:] == 100000.0).all()
        r, o = tt.score_block(tb, raw[:30], None if flow is None else flow[:30])
        np.testing.assert_allclose(
            ts[:30], (r - np.float32(mu_r)) / np.float32(sd_r)
            + (o - np.float32(mu_o)) / np.float32(sd_o), rtol=1e-6, atol=1e-6)
        bound = 1e-5 * (np.abs(r).max() / sd_r + np.abs(o).max() / sd_o)
        np.testing.assert_allclose(ts, js, rtol=0, atol=bound)


def test_infer_resident_two_stream_matches_jax():
    """infer_frame_scores_resident with a flow stack against JAX's, on the
    same weights, frames and flow: within 2e-4 (PARITY.md:26). Every third
    frame's flow is zero and motion_thr is above 0, so the motion filter
    drops those frames' cubes (-big_number there in both)."""
    jcfg, tcfg = (c.replace(fore=dataclasses.replace(c.fore, motion_thr=1e-3))
                  for c in _configs(0))
    jb = _jax_fit(True)
    tb = _as_port_block(jb)
    from vec_vad_torch.data.synthetic import make_synthetic_dataset
    from vec_vad_torch.data.video_index import VideoIndex

    ds = make_synthetic_dataset(frames_per_video=13, n_train_videos=1,
                                n_test_videos=2, frame_h=HW[0], frame_w=HW[1], seed=13)
    n = ds.test_frames.shape[0]
    rng = np.random.default_rng(14)
    flow = rng.normal(0.0, 2.0, (n,) + HW + (2,)).astype(np.float32)
    flow[::3] = 0.0
    idx = VideoIndex(["a", "b"], ds.test_video_lengths)
    windows = idx.context_indices(4, "predict")
    of_windows = idx.context_indices(0, "predict").reshape(n, -1)
    boxes_pad, valid = t_pad_boxes(ds.test_boxes, 8)
    stats = tb.raw_stats + tb.of_stats
    args = (stats, ds.test_frames, windows, boxes_pad, valid)
    kw = dict(flow=flow, of_windows=of_windows, chunk=8, cube_batch=16)
    js = j_resident(jcfg, {"params": jb.params, "batch_stats": jb.batch_stats},
                    *args, **kw)
    ts = t_resident(tcfg, tb.state_dict, *args, **kw, device="cpu")
    assert ts.shape == (n,) and ts.dtype == np.float32
    dropped = valid[::3].any(axis=1)
    assert dropped.any() and (ts[::3][dropped] == -100000.0).all()
    assert (ts[1::3] > -100000.0).any()
    np.testing.assert_allclose(ts, js, rtol=2e-4, atol=2e-4)
    # the flow as a tensor on the device, and without flow: raw alone
    ts_dev = t_resident(tcfg, tb.state_dict, *args, **dict(kw, flow=torch.from_numpy(flow)),
                        device="cpu")
    np.testing.assert_array_equal(ts_dev, ts)
    no_flow = t_resident(tcfg, tb.state_dict, *args, chunk=8, cube_batch=16, device="cpu")
    raw_only = t_resident(tcfg, tb.state_dict, tb.raw_stats + (0.0, 1.0), ds.test_frames,
                          windows, boxes_pad, valid, chunk=8, cube_batch=16, device="cpu")
    np.testing.assert_array_equal(no_flow, raw_only)
    np.testing.assert_allclose(
        no_flow, j_resident(jcfg, {"params": jb.params, "batch_stats": jb.batch_stats},
                            *args, chunk=8, cube_batch=16), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# run_train -> run_test on a UCSD-layout workspace with a flow tree
# ---------------------------------------------------------------------------


def _register():
    for c in (j_config, t_config):
        if DATASET not in c.DATASETS:
            c.register_dataset(dataclasses.replace(
                c.DATASETS["UCSDped2"], name=DATASET, file_ext=".npy"))


def _write_flow_tree(base, seed):
    """A seeded float32 (H, W, 2) map for every frame, mirrored under
    optical_flow/ (the calc-flow layout), in place of FlowNet2's."""
    rng = np.random.default_rng(seed)
    root = os.path.join(base, "raw_datasets", DATASET)
    for split in ("Train", "Test"):
        for v in range(len(LENGTHS)):
            d = os.path.join(base, "optical_flow", DATASET, split, f"{split}{v + 1:03d}")
            os.makedirs(d, exist_ok=True)
            for t in range(LENGTHS[v]):
                assert os.path.exists(os.path.join(root, split, f"{split}{v + 1:03d}",
                                                   f"{t:03d}.npy"))
                np.save(os.path.join(d, f"{t:03d}.npy"),
                        rng.normal(0.0, 2.0, HW + (2,)).astype(np.float32))


def _write_workspace(base):
    """Seeded synthetic videos as uint8 .npy frames in the UCSD layout,
    .bmp label masks, the bbox fixture files and a flow tree."""
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
    _write_flow_tree(base, 15)


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    """run_train then run_test (with and without per_video_norm) in each
    package over its own copy of one workspace, both from JAX's
    init_state(0) (the port's init_state is patched to its transplant)."""
    _register()
    jcfg, tcfg = _configs(0)
    out = {}
    for name in ("jax", "torch"):
        base = str(tmp_path_factory.mktemp(f"ws2_{name}"))
        _write_workspace(base)
        out[name] = base
    _, _, params, stats = _jax_init(0, 0)
    mp = pytest.MonkeyPatch()
    mp.setattr(BlockTrainer, "init_state",
               lambda self, seed: self.state_from_variables(params, stats))
    mp.setattr(j_runner, "make_trainer", lambda cfg: _jax_trainer(0))
    try:
        jm, jpath = j_runner.run_train(jcfg, out["jax"])
        jres = [j_runner.run_test(jcfg, out["jax"], model=jm, per_video_norm=pv)
                for pv in (False, True)]
        tm, tpath = t_runner.run_train(tcfg, out["torch"], device="cpu")
        tres = [t_runner.run_test(tcfg, out["torch"], per_video_norm=pv, device="cpu")
                for pv in (False, True)]
    finally:
        mp.undo()
    return dict(jcfg=jcfg, tcfg=tcfg, base=out, jm=jm, tm=tm, jpath=jpath,
                tpath=tpath, jres=jres, tres=tres)


def test_run_train_run_test_two_stream_match_jax(workspaces):
    """Both streams trained over the flow tree: raw and flow training
    scores, frame scores with and without per-video normalisation within
    5e-4 of their largest, equal labels and AUROCs within 0.02."""
    w = workspaces
    assert sorted(w["tm"].blocks) == sorted(w["jm"].blocks) == [(0, 0, 0)]
    tb, jb = w["tm"].blocks[(0, 0, 0)], w["jm"].blocks[(0, 0, 0)]
    assert tb.raw_scores.shape == tb.of_scores.shape == jb.of_scores.shape == (76,)
    assert _rel(tb.raw_scores, jb.raw_scores) <= E2E_REL
    assert _rel(tb.of_scores, jb.of_scores) <= E2E_REL
    for tres, jres in zip(w["tres"], w["jres"]):
        tf, jf = tres["frame_scores"], jres["frame_scores"]
        assert tf.shape == jf.shape == (38,) and np.isfinite(tf).all()
        assert _rel(tf, jf) <= E2E_REL, _rel(tf, jf)
        np.testing.assert_array_equal(tres["labels"], jres["labels"])
        assert abs(tres["auroc"] - jres["auroc"]) <= 0.02
    want = t_scoring.normalize_scores_per_video(w["tres"][0]["frame_scores"],
                                                np.repeat([1, 2], LENGTHS))
    np.testing.assert_allclose(w["tres"][1]["frame_scores"], want, rtol=1e-6, atol=1e-6)


def test_saved_two_stream_models_score_the_same_in_either_package(workspaces):
    """Each package loads the other's two-stream .npz (of_scores bit for
    bit) and scores its own test split with it as it scores its own."""
    w = workspaces
    jm_in_t = t_art.load_vad_model(w["jpath"])
    tm_in_j = j_art.load_vad_model(w["tpath"])
    for got, want in ((jm_in_t, w["jm"]), (tm_in_j, w["tm"])):
        for k in ("raw_scores", "of_scores"):
            np.testing.assert_array_equal(getattr(got.blocks[(0, 0, 0)], k),
                                          getattr(want.blocks[(0, 0, 0)], k))
    t_with_j = t_runner.run_test(w["tcfg"], w["base"]["torch"], model=jm_in_t,
                                 device="cpu")["frame_scores"]
    j_with_t = j_runner.run_test(w["jcfg"], w["base"]["jax"], model=tm_in_j)["frame_scores"]
    assert _rel(j_with_t, w["tres"][0]["frame_scores"]) <= CROSS_REL
    assert _rel(t_with_j, w["jres"][0]["frame_scores"]) <= CROSS_REL
    tm_back = t_art.load_vad_model(w["tpath"])
    for k, v in w["tm"].blocks[(0, 0, 0)].state_dict.items():
        assert torch.equal(tm_back.blocks[(0, 0, 0)].state_dict[k], v), k


def test_port_trained_two_stream_model_serves_in_the_port(workspaces):
    """The two-stream VadModel run_train returns streams through
    StreamingScorer with the flow tree's maps pushed beside the frames:
    its per-frame scores equal run_test's (within 2e-4, PARITY.md:26)."""
    from vec_vad_torch.serve import StreamingScorer

    w = workspaces
    data = t_runner.load_split(w["tcfg"], w["base"]["torch"], "test")
    assert data.flow is not None
    scorer = StreamingScorer.from_model(w["tm"], route_hw=HW, device="cpu")
    got, f = [], 0
    for n in data.index.video_lengths:
        scorer.start_video()
        for _ in range(int(n)):
            got.append(scorer.push(np.asarray(data.frames[f]), data.boxes[f],
                                   flow=data.flow[f]))
            f += 1
    np.testing.assert_allclose(np.asarray(got, np.float64), w["tres"][0]["frame_scores"],
                               rtol=2e-4, atol=2e-4)


def test_cli_two_stream_and_the_cube_cache_keys_on_the_flow_tree(tmp_path, monkeypatch,
                                                                    capsys):
    """`train` and `test --per-video-norm` from a config.cfg with
    useFlow = True; rewriting the flow tree (a calc-flow rerun) between
    two `train` runs re-extracts the cubes, and the second model's flow
    training scores differ. A rerun over the same tree hits the cache."""
    _register()
    base = str(tmp_path)
    _write_workspace(base)
    ini = os.path.join(base, "config.cfg")
    with open(ini, "w") as f:
        f.write(f"[shared_parameters]\ndataset_name = {DATASET}\n"
                f"[{DATASET}]\npatch_size = {P}\n"
                f"[SelfComplete]\nepochs = {EPOCHS}\nbatch_size = {BATCH}\n"
                f"nf = {NF}\nuseFlow = True\ncontext_of_num = 0\n")
    extracted = []
    extract = t_runner.extract_cube_set

    def counting(*a, **k):
        extracted.append(k["flow_frames"] is not None)
        return extract(*a, **k)

    monkeypatch.setattr(t_runner, "extract_cube_set", counting)
    train = ["train", "--config", ini, "--base", base, "--device", "cpu"]
    models = []
    for rewrite in (False, False, True):
        if rewrite:
            _write_flow_tree(base, 16)
        assert t_cli.main(train) == 0
        path = capsys.readouterr().out.split(" -> ")[-1].strip()
        models.append(t_art.load_vad_model(path).blocks[(0, 0, 0)])
    assert extracted == [True, True]  # first run, then after the rewrite
    np.testing.assert_array_equal(models[1].of_scores, models[0].of_scores)
    assert models[2].of_scores.shape == models[0].of_scores.shape == (76,)
    assert _rel(models[2].of_scores, models[0].of_scores) > 1e-3
    np.testing.assert_array_equal(models[2].raw_scores, models[0].raw_scores)
    assert t_cli.main(["test", "--config", ini, "--base", base, "--per-video-norm",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "frame-level AUROC: " in out and "curves -> " in out
