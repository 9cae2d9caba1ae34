"""The model grid in the port — GridTrainer (the blocks folded into one
network), train_model's and score_cubes' routing, infer_frame_scores_grid,
BlockTrainer.fit_block_budget, StageTimer and the demo — held against
vec_vad_tpu on the same numpy-seeded cubes and initial weights, at nf=4,
patch 16, batch 16, 2 epochs, on a 2x2 grid over the synthetic generator's
48x64 videos (tests/test_grid_parallel.py's world)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
from vec_vad_torch import config as t_config
from vec_vad_torch import pipeline as t_pipe
from vec_vad_torch.data.synthetic import make_synthetic_dataset
from vec_vad_torch.data.video_index import VideoIndex
from vec_vad_torch.infer import infer_frame_scores_grid as t_infer_grid
from vec_vad_torch.models.convert import completion_from_jax
from vec_vad_torch.runtime.profiling import StageTimer as TStageTimer
from vec_vad_torch.train import grid_trainer as t_grid
from vec_vad_torch.train.trainer import BlockTrainer
from vec_vad_tpu import config as j_config
from vec_vad_tpu import pipeline as j_pipe
from vec_vad_tpu.infer import infer_frame_scores_grid as j_infer_grid
from vec_vad_tpu.parallel.mesh import get_mesh
from vec_vad_tpu.runtime.profiling import StageTimer as JStageTimer
from vec_vad_tpu.train import grid_trainer as j_grid
from vec_vad_tpu.train import trainer as j_trainer
from vec_vad_tpu.train.trainer import make_loss_fn, make_train_step

P, NF, BATCH, EPOCHS, SEED = 16, 4, 16, 2, 3
DATASET = "synthGrid_torch"
HW = (48, 64)
# port against JAX from the same initial weights: training scores after
# the fit relative to their largest (measured <= 4.7e-4), and the weights
# after one step relative to the net's largest (BatchNorm's scale, ~1).
# Trained weights are not held element by element: a convolution bias
# right before a BatchNorm has a gradient of 0 up to rounding, which Adam
# scales to steps of up to lr either way, and the 2x2 bottom level's
# statistics over a few rows amplify rounding (up to 5.7e-3 of the largest
# weight after the 2 epochs, 1.6e-3 between the port's own sequential
# loop and JAX's)
JAX_SCORE_REL, JAX_WEIGHT_REL = 1e-3, 1e-4
# the port's grid against its own sequential loop: the same arithmetic in
# other orders (oneDNN sums the folded convolutions in its own order; a
# full batch beside a padded one takes the masked statistics), grown over
# the fit; measured <= 8.2e-5 for raw scores, 4.5e-4 for flow scores (JAX's
# own bound for this comparison: rtol 2e-3, atol 1e-4)
SEQ_REL = 1e-3
# bf16 against JAX's bf16: the first loss, within bf16's unit roundoff
# (2^-8; the port's own sequential first loss is up to 1.5e-3 from JAX's
# on these batches), and the training scores after the fit, relative to
# their largest (measured <= 8.1e-3; the port's own sequential bf16 fit
# is up to 8.4e-3 from JAX's)
BF16_LOSS_REL, BF16_SCORE_REL = 4e-3, 1.5e-2
# the same weights scored in either package (PARITY.md:26)
CROSS_REL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _configs(use_flow=False, compute_dtype="float32"):
    """The same 2x2-grid configuration in both packages."""
    out = []
    for c in (j_config, t_config):
        c.register_dataset(dataclasses.replace(c.DATASETS["UCSDped2"], name=DATASET,
                                               frame_h=HW[0], frame_w=HW[1]))
        out.append(c.PipelineConfig(
            dataset_name=DATASET,
            fore=c.ForegroundConfig(patch_size=P, max_boxes_per_frame=8,
                                    h_block=2, w_block=2),
            model=c.CompletionConfig(nf=NF, epochs=EPOCHS, batch_size=BATCH,
                                     context_of_num=0, use_flow=use_flow,
                                     compute_dtype=compute_dtype),
        ))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _world():
    """Train and test CubeSets (numpy, extracted by the port on the CPU),
    the train split once with seeded flow maps (tests/test_grid_parallel.py's)."""
    ds = make_synthetic_dataset(frames_per_video=24, n_train_videos=2,
                                n_test_videos=2, frame_h=HW[0], frame_w=HW[1], seed=11)
    _, tcfg = _configs()
    spec = t_config.DATASETS[DATASET]
    train_idx = VideoIndex(["t0", "t1"], ds.train_video_lengths)
    test_idx = VideoIndex(["s0", "s1"], ds.test_video_lengths)
    d = np.diff(ds.train_frames.astype(np.float32).mean(-1), axis=0,
                append=ds.train_frames[-1:].mean(-1))
    flow = np.stack([d, -d], axis=-1) / 25.0
    train = t_pipe.extract_cube_set(tcfg, spec, train_idx, ds.train_frames,
                                    ds.train_boxes, device="cpu")
    train_of = t_pipe.extract_cube_set(_configs(True)[1], spec, train_idx,
                                       ds.train_frames, ds.train_boxes,
                                       flow_frames=flow, device="cpu")
    test = t_pipe.extract_cube_set(tcfg, spec, test_idx, ds.test_frames, ds.test_boxes,
                                   block_mode=tcfg.fore.test_block_mode, device="cpu")
    return ds, train, train_of, test, test_idx


def _block_data(cubes):
    return [(key, cubes.raw[idx], None if cubes.flow is None else cubes.flow[idx])
            for key, idx in t_pipe.group_by_block(cubes).items() if idx.size > 1]


def _jax_cubes(c):
    return j_pipe.CubeSet(raw=c.raw, flow=c.flow, frame_ids=c.frame_ids, boxes=c.boxes,
                          cells=c.cells, scenes=c.scenes)


@functools.lru_cache(maxsize=None)
def _jax_trainer(use_flow=False, compute_dtype="float32"):
    return j_pipe.make_trainer(_configs(use_flow, compute_dtype)[0])


@functools.lru_cache(maxsize=None)
def _jax_init(use_flow=False, compute_dtype="float32"):
    """JAX's init for SEED (its GridTrainer's _stacked_init broadcasts the
    same) as the port's state dict."""
    st = _jax_trainer(use_flow, compute_dtype).init_state(SEED)
    return completion_from_jax(jax.tree.map(np.asarray, st.params),
                               jax.tree.map(np.asarray, st.batch_stats))


@functools.lru_cache(maxsize=None)
def _jax_fit(use_flow=False, compute_dtype="float32"):
    """JAX's GridTrainer.fit_blocks over the world's eligible blocks."""
    jcfg = _configs(use_flow, compute_dtype)[0]
    jt = _jax_trainer(use_flow, compute_dtype)
    gt = j_grid.get_grid_trainer(jt.net, jcfg.model, get_mesh(), P)
    cubes = _world()[2 if use_flow else 1]
    return gt.fit_blocks(_block_data(cubes), seed=SEED)


@functools.lru_cache(maxsize=None)
def _port_fit(use_flow=False, compute_dtype="float32"):
    """The port's fit_blocks over the same blocks from JAX's init."""
    tcfg = _configs(use_flow, compute_dtype)[1]
    gt = t_grid.GridTrainer(tcfg.model, P, "cpu")
    cubes = _world()[2 if use_flow else 1]
    return gt.fit_blocks(_block_data(cubes), seed=SEED,
                         init_state=_jax_init(use_flow, compute_dtype))


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


def _weight_rel(got, want):
    largest = max(float(v.abs().max()) for v in want.values())
    return max(float((got[k] - want[k]).abs().max()) for k in want) / largest


# ---------------------------------------------------------------------------
# GridTrainer against JAX's and against the port's own sequential loop
# ---------------------------------------------------------------------------


def test_world_spreads_over_the_grid():
    _, train, train_of, test, _ = _world()
    for c in (train, train_of):
        sizes = sorted(v.size for v in t_pipe.group_by_block(c).values())
        assert len([s for s in sizes if s > 1]) >= 3, sizes
        assert len(set(sizes)) > 1  # ragged: the blocks' schedules end apart
    assert test.size > 0


@pytest.mark.parametrize("use_flow", [False, True])
def test_fit_blocks_matches_jax(use_flow):
    """From JAX's init: every block's training scores (and flow scores)
    within 1e-3 of the largest of JAX's GridTrainer's, its loss schedule
    as long as its own fit_block's."""
    tb, jb = _port_fit(use_flow), _jax_fit(use_flow)
    assert list(tb) == list(jb) and len(tb) >= 3
    for key, raw, _ in _block_data(_world()[2 if use_flow else 1]):
        t, j = tb[key], jb[key]
        assert t.losses.shape == (EPOCHS * -(-raw.shape[0] // BATCH),)
        assert _rel(t.raw_scores, j.raw_scores) <= JAX_SCORE_REL, key
        if use_flow:
            assert t.of_scores is not None and _rel(t.of_scores, j.of_scores) <= JAX_SCORE_REL
        else:
            assert t.of_scores is None and j.of_scores is None


def test_first_grid_step_matches_jax():
    """One grid step (each block's first 16 cubes, 1 epoch: two full
    batches beside two padded ones, so the (G, B) mask) from JAX's init
    against JAX's make_train_step on each block's batch: every weight and
    running statistic within 1e-4 of the net's largest; a convolution bias
    right before a BatchNorm (gradient 0 up to rounding) moved by at most
    lr in both packages."""
    jcfg, tcfg = _configs()
    one = dataclasses.replace(tcfg.model, epochs=1)
    data = [(k, raw[:BATCH], None) for k, raw, _ in _block_data(_world()[1])]
    assert {raw.shape[0] for _, raw, _ in data} == {13, 14, BATCH}
    init = _jax_init()
    got = t_grid.GridTrainer(one, P, "cpu").fit_blocks(data, seed=SEED, init_state=init)
    jt = _jax_trainer()
    st = jt.init_state(SEED)
    step = jax.jit(make_train_step(jt.net, jcfg.model, jt.tx))
    bt = BlockTrainer(one, P, "cpu")
    lr = one.learning_rate
    for key, raw, _ in data:
        idx, w = bt._epoch_schedule(raw.shape[0], np.random.default_rng(SEED))
        x = raw[idx[0]].astype(np.float32) / 255.0
        jst, _ = step(st, x, np.zeros(x.shape[:-1] + (2,), np.float32), w[0])
        want = completion_from_jax(jax.tree.map(np.asarray, jst.params),
                                   jax.tree.map(np.asarray, jst.batch_stats))
        largest = max(float(v.abs().max()) for v in want.values())
        for name, t in got[key].state_dict.items():
            if name.endswith(("conv0.bias", "conv1.bias")):
                for moved in (t, want[name]):
                    assert float((moved - init[name]).abs().max()) <= lr * (1 + 1e-5)
                continue
            assert float((t - want[name]).abs().max()) <= JAX_WEIGHT_REL * largest, name


@pytest.mark.parametrize("use_flow", [False, True])
def test_grid_matches_sequential(use_flow):
    """The port's grid against its own fit_block, block by block from the
    same init: training scores and losses within 1e-4 of their largest."""
    tcfg = _configs(use_flow)[1]
    bt = BlockTrainer(tcfg.model, P, "cpu")
    cubes = _world()[2 if use_flow else 1]
    grid = _port_fit(use_flow)
    for key, raw, of in _block_data(cubes):
        solo = bt.fit_block(raw, of, seed=SEED, init_state=_jax_init(use_flow))
        g = grid[key]
        assert g.losses.shape == solo.losses.shape
        assert _rel(g.raw_scores, solo.raw_scores) <= SEQ_REL, key
        assert _rel(g.losses, solo.losses) <= SEQ_REL, key
        if use_flow:
            assert _rel(g.of_scores, solo.of_scores) <= SEQ_REL, key


def _ragged_blocks():
    """A block with fewer steps than the other's first epoch (7 cubes: 1
    step an epoch, 2 in all, against 40 cubes' 3 an epoch)."""
    rng = np.random.default_rng(5)
    big = rng.integers(0, 256, (40, P, P, 15), dtype=np.uint8)
    small = rng.integers(0, 256, (7, P, P, 15), dtype=np.uint8)
    return big, small


def _ragged_grid_fit(tcfg, blocks, steps, held=None):
    """(fit, finished blocks) of a 2-block grid's first `steps` steps, the
    grid net held in `held` (default: as built)."""
    gt = t_grid.GridTrainer(tcfg.model, P, "cpu")
    if held is not None:
        gt.net(2).to(memory_format=held)
    fit = gt.prepare(blocks, gt.solo.init_state(SEED), SEED)
    return fit, fit.finish(fit.losses([fit.step(s) for s in range(steps)]))


def _assert_finished_block_equals(fit, out, want_state, want_adam):
    """The small block (grid block 1, key (0, 0, 0)) after the ragged
    grid's 6 steps: weights and running statistics, Adam's step and both
    moments within 1e-6 of their largest."""
    assert _weight_rel(out[(0, 0, 0)].state_dict, want_state) <= 1e-6
    st = fit.adam.block_state(1)
    assert st["step"] == want_adam["step"] == 2 and fit.adam.block_state(0)["step"] == 6
    for moment in ("exp_avg", "exp_avg_sq"):
        assert st[moment].keys() == want_adam[moment].keys()
        for name, w in want_adam[moment].items():
            assert float((st[moment][name] - w).abs().max()) <= 1e-6 * max(
                float(w.abs().max()), 1e-30), (name, moment)


def test_ragged_grid_finished_block_equals_its_solo_fit():
    """A block with fewer steps than the other's first epoch stops while
    the other trains on, and its two steps are its solo fit's.

    As built (channels_last): its two losses equal the solo BlockTrainer
    fit's within 1e-6, and its weights, running statistics and Adam state
    (step and both moments) after the grid's 6 steps equal, within 1e-6
    of their largest, those of the same block fit for its 2 steps in a
    grid of the same width beside a block of its own length. The
    parameters are held to that grid, not to the solo fit: on the CPU a
    channels_last reduction rounds each channel by the tensor's width
    (torch's outer sums over rows of channels), so a 2-block grid's first
    gradients differ from a 1-block net's by up to ~7e-6 of each
    parameter's largest (wholly for the DoubleConv biases before a
    train-mode BatchNorm, whose gradient is 0 but for rounding), and Adam
    turns such differences in near-zero entries into steps of up to lr.

    Held NCHW, where the CPU sums every channel alike whatever the width,
    the same block after the same 6 grid steps equals the solo fit
    itself: losses, weights, statistics and Adam state within 1e-6."""
    _, tcfg = _configs()
    big, small = _ragged_blocks()
    ragged = [((0, 1, 1), big, None), ((0, 0, 0), small, None)]
    for held in (None, torch.contiguous_format):
        fit, out = _ragged_grid_fit(tcfg, ragged, 6, held)
        assert list(fit.active) == [2, 2, 1, 1, 1, 1]
        assert fit.net.raw_unets.memory_format(torch.float32) == (
            held or torch.channels_last)
        assert out[(0, 0, 0)].losses.shape == (2,) and out[(0, 1, 1)].losses.shape == (6,)
        bt = BlockTrainer(tcfg.model, P, "cpu")
        if held is not None:
            bt.net.to(memory_format=held)
        solo = bt.fit_block(small, None, seed=SEED)
        assert _rel(out[(0, 0, 0)].losses, solo.losses) <= 1e-6
        if held is None:
            partner = np.random.default_rng(9).integers(0, 256, small.shape, dtype=np.uint8)
            even, even_out = _ragged_grid_fit(
                tcfg, [((0, 1, 1), partner, None), ((0, 0, 0), small, None)], 2)
            assert list(even.active) == [2, 2]
            _assert_finished_block_equals(fit, out, even_out[(0, 0, 0)].state_dict,
                                          even.adam.block_state(1))
        else:
            params = dict(bt.net.named_parameters())
            assert {int(bt.opt.state[p]["step"]) for p in params.values()} == {2}
            want_adam = {"step": 2, **{m: {n: bt.opt.state[p][m] for n, p in params.items()}
                                       for m in ("exp_avg", "exp_avg_sq")}}
            _assert_finished_block_equals(fit, out, solo.state_dict, want_adam)


def test_memory_budget_splits_the_grid_into_calls(monkeypatch):
    """A memory budget of one block's step runs each block in a call of its
    own (max_blocks 1): the blocks come back in block_data's order, each
    equal to its own fit_block bit for bit; score_blocks under a budget of
    two blocks' batches equals the unbounded fold within 1e-5."""
    _, tcfg = _configs()
    data = _block_data(_world()[1])
    gt = t_grid.GridTrainer(tcfg.model, P, "cpu")
    monkeypatch.setattr(t_grid, "_CPU_BUDGET", 1.5 * gt.block_bytes(BATCH, train=True))
    assert gt.max_blocks(BATCH, train=True) == 1
    out = gt.fit_blocks(data, seed=SEED)
    assert list(out) == [k for k, _, _ in data]
    bt = BlockTrainer(tcfg.model, P, "cpu")
    for key, raw, _ in data:
        np.testing.assert_array_equal(out[key].raw_scores,
                                      bt.fit_block(raw, None, seed=SEED).raw_scores)
    test = _world()[3]
    blocks = [(k, test.raw[i], None) for k, i in t_pipe.group_by_block(test).items()
              if k in out]
    monkeypatch.setattr(t_grid, "_CPU_BUDGET", 2.5 * gt.block_bytes(BATCH, train=False))
    got = gt.score_blocks(out, blocks)
    monkeypatch.undo()
    want = gt.score_blocks(out, blocks)
    assert len(blocks) > 2 and list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key][0], want[key][0], rtol=1e-5)


def test_bf16_grid_matches_jax():
    """compute_dtype bfloat16: each block's first loss within 4e-3 of JAX's
    bf16 loss on the same batch (make_loss_fn), its training scores
    within 1.5e-2 of the largest of JAX's bf16 GridTrainer's; f32 masters."""
    jcfg, tcfg = _configs(False, "bfloat16")
    tb, jb = _port_fit(False, "bfloat16"), _jax_fit(False, "bfloat16")
    st = _jax_trainer(False, "bfloat16").init_state(SEED)
    loss_fn = jax.jit(make_loss_fn(_jax_trainer(False, "bfloat16").net, jcfg.model))
    bt = BlockTrainer(tcfg.model, P, "cpu")
    for key, raw, _ in _block_data(_world()[1]):
        idx, w = bt._epoch_schedule(raw.shape[0], np.random.default_rng(SEED))
        x = raw[idx[0]].astype(np.float32) / 255.0
        want, _ = loss_fn(st.params, st.batch_stats, x, np.zeros(x.shape[:-1] + (2,),
                                                                 np.float32), w[0])
        assert abs(tb[key].losses[0] - float(want)) <= BF16_LOSS_REL * abs(float(want))
        assert _rel(tb[key].raw_scores, jb[key].raw_scores) <= BF16_SCORE_REL, key
        assert all(v.dtype == torch.float32 for v in tb[key].state_dict.values())


# ---------------------------------------------------------------------------
# scoring: score_cubes' grid branch and infer_frame_scores_grid
# ---------------------------------------------------------------------------


def _models():
    """JAX's grid-trained raw model with one block left out (its test
    cubes score big_number), and the same weights as the port's model."""
    jcfg, tcfg = _configs()
    jb = dict(_jax_fit())
    jb.pop(sorted(jb)[0])
    jm = j_pipe.VadModel(cfg=jcfg, blocks=jb)
    tm = t_pipe.VadModel(cfg=tcfg, blocks={
        k: t_pipe.TrainedBlock(
            state_dict=completion_from_jax(jax.tree.map(np.asarray, b.params),
                                           jax.tree.map(np.asarray, b.batch_stats)),
            raw_scores=b.raw_scores, of_scores=b.of_scores)
        for k, b in jb.items()})
    return jm, tm


def test_score_cubes_grid_branch_matches_jax(monkeypatch):
    """score_cubes on a multi-block model takes the folded grid scorer (as
    JAX's takes its GridTrainer): within 2e-4 of the largest finite score
    of JAX's, the untrained block's cubes big_number in both; the
    sequential scoring of the same model agrees within 2e-4 too."""
    _, _, _, test, _ = _world()
    jm, tm = _models()
    calls = []
    score_blocks = t_grid.GridTrainer.score_blocks
    monkeypatch.setattr(t_grid.GridTrainer, "score_blocks",
                        lambda self, *a, **k: calls.append(1) or score_blocks(self, *a, **k))
    got = t_pipe.score_cubes(tm, test, device="cpu")
    assert calls == [1]
    want = j_pipe.score_cubes(jm, _jax_cubes(test), trainer=_jax_trainer())
    big = want == t_pipe.BIG_NUMBER
    assert big.any() and (~big).any()
    np.testing.assert_array_equal(got == t_pipe.BIG_NUMBER, big)
    assert _rel(got[~big], want[~big]) <= CROSS_REL
    # the sequential branch (float cubes) on the same weights
    seq = t_pipe.score_cubes(tm, dataclasses.replace(test, raw=test.raw.astype(np.float32)
                                                     / 255.0), device="cpu")
    assert calls == [1]
    assert _rel(seq[~big], got[~big]) <= CROSS_REL


def test_infer_frame_scores_grid_matches_jax():
    """infer_frame_scores_grid against JAX's on the same model and cubes
    (2e-4 of the largest), and against frame_level_scores(score_cubes(...))
    of the port; a batch of 5 rows a block gives the same scores."""
    _, _, _, test, test_idx = _world()
    jm, tm = _models()
    n = test_idx.total_frames
    got = t_infer_grid(tm, test, n, device="cpu")
    want = j_infer_grid(jm, _jax_cubes(test), n, trainer=_jax_trainer())
    assert got.shape == want.shape == (n,)
    np.testing.assert_array_equal(got == -t_pipe.BIG_NUMBER, want == -t_pipe.BIG_NUMBER)
    assert _rel(got, want) <= CROSS_REL
    offline = t_pipe.frame_level_scores(t_pipe.score_cubes(tm, test, device="cpu"), test, n)
    assert _rel(got, offline) <= CROSS_REL
    assert _rel(t_infer_grid(tm, test, n, cube_batch=5, device="cpu"), got) <= CROSS_REL


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _route_cubes(case):
    """A CubeSet for one of JAX's four routing cases."""
    _, train, _, _, _ = _world()
    if case == "float":
        return dataclasses.replace(train, raw=train.raw.astype(np.float32) / 255.0)
    if case == "single":
        return dataclasses.replace(train, cells=np.zeros_like(train.cells))
    return train


@pytest.mark.parametrize("case,seg,grid", [
    ("uint8", 1000, True), ("float", 1000, False), ("single", 1000, False),
    ("uint8", 8, False),
])
def test_train_model_routes_like_jax(monkeypatch, case, seg, grid):
    """parallel_blocks=None: the grid exactly when JAX selects it — uint8
    cubes, more than one eligible block, none over save_seg_num — in both
    packages (their trainers replaced by recorders)."""
    routes = {"t": [], "j": []}

    def rec(pkg, name):
        def fn(self, *a, **k):
            routes[pkg].append(name)
            data = a[0] if name == "grid" else None
            return {key: None for key, _, _ in data} if name == "grid" else None
        return fn

    monkeypatch.setattr(t_grid.GridTrainer, "fit_blocks", rec("t", "grid"))
    monkeypatch.setattr(BlockTrainer, "fit_block", rec("t", "seq"))
    monkeypatch.setattr(j_grid.GridTrainer, "fit_blocks", rec("j", "grid"))
    monkeypatch.setattr(j_trainer.BlockTrainer, "fit_block", rec("j", "seq"))
    jcfg, tcfg = _configs()
    jcfg = jcfg.replace(fore=dataclasses.replace(jcfg.fore, save_seg_num=seg))
    tcfg = tcfg.replace(fore=dataclasses.replace(tcfg.fore, save_seg_num=seg))
    cubes = _route_cubes(case)
    t_pipe.train_model(tcfg, cubes, device="cpu")
    j_pipe.train_model(jcfg, _jax_cubes(cubes), trainer=_jax_trainer())
    assert routes["t"] == routes["j"]
    assert set(routes["t"]) == {"grid" if grid else "seq"}


def test_train_model_grid_on_device_resident_rows():
    """parallel_blocks=True on a CubeSet whose rows are tensors (the
    resident extraction's) trains as on numpy rows, bit for bit."""
    _, tcfg = _configs()
    _, train, _, _, _ = _world()
    a = t_pipe.train_model(tcfg, train, seed=SEED, parallel_blocks=True, device="cpu")
    b = t_pipe.train_model(tcfg, dataclasses.replace(train, raw=torch.from_numpy(train.raw)),
                           seed=SEED, device="cpu")
    assert list(a.blocks) == list(b.blocks) and len(a.blocks) >= 3
    for key in a.blocks:
        np.testing.assert_array_equal(a.blocks[key].raw_scores, b.blocks[key].raw_scores)


def test_mixed_flow_blocks_raise_like_jax():
    """Flow and flow-less blocks in one call raise ValueError in both."""
    jcfg, tcfg = _configs(True)
    _, _, train_of, _, _ = _world()
    data = _block_data(train_of)[:2]
    data[1] = (data[1][0], data[1][1], None)
    with pytest.raises(ValueError, match="mixes flow"):
        t_grid.GridTrainer(tcfg.model, P, "cpu").fit_blocks(data)
    with pytest.raises(ValueError, match="mixes flow"):
        j_grid.GridTrainer._uniform_has_flow(data)


# ---------------------------------------------------------------------------
# fit_block_budget, StageTimer, the demo
# ---------------------------------------------------------------------------


def test_fit_block_budget_phases():
    """fit_block_budget reports JAX's phases (tests/test_trainer_resident.py:
    203-230), each >= 0, total their sum, and its run is a fit_block: the
    net holds weights that score as fit_block's (1e-6)."""
    _, tcfg = _configs()
    bt = BlockTrainer(tcfg.model, P, "cpu")
    raw = np.random.default_rng(1).integers(0, 256, (40, P, P, 15), dtype=np.uint8)
    budget = bt.fit_block_budget(raw, None, seed=SEED)
    phases = ("init_state_s", "schedule_host_s", "upload_s", "train_scan_s",
              "score_pass_s", "param_download_s")
    assert set(budget) == set(phases) | {"total_s"}
    assert all(budget[p] >= 0.0 for p in phases)
    assert abs(budget["total_s"] - sum(budget[p] for p in phases)) < 1e-9
    r, _ = bt._score(bt.upload(raw), None)
    blk = bt.fit_block(raw, None, seed=SEED)
    np.testing.assert_allclose(r, blk.raw_scores, rtol=1e-6)


def test_stage_timer_reports_like_jax(monkeypatch):
    """StageTimer: the same nested names, counts and report layout as the
    JAX package's under the same (fixed) clock."""
    import vec_vad_torch.runtime.profiling as tp
    import vec_vad_tpu.runtime.profiling as jp

    reports = []
    for mod, cls in ((tp, TStageTimer), (jp, JStageTimer)):
        clock = iter(np.arange(0.0, 100.0, 0.25))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: float(next(clock)))
        t = cls()
        assert t.report() == "(no stages recorded)"
        with t.stage("train"):
            with t.stage("step"):
                pass
            with t.stage("step"):
                pass
        with t.stage("test"):
            pass
        reports.append((t.report(), t.as_dict()))
    assert reports[0] == reports[1]
    assert reports[0][1]["train/step"] == (0.5, 2)


def test_demo_runs_on_the_cpu(tmp_path):
    """The demo at a tiny size on the CPU: train and test on its synthetic
    tree, a finite AUROC, the StageTimer's stages, the dataset table given
    back, and the workspace kept under --base."""
    from vec_vad_torch import demo

    before = t_config.DATASETS["avenue"]
    res = demo.main(device="cpu", base=str(tmp_path), frames_per_video=12,
                    n_train_videos=2, n_test_videos=2, nf=4, epochs=1, batch_size=16)
    assert np.isfinite(res["auroc"])
    assert list(res["timer"].totals) == ["write", "train", "test"]
    assert t_config.DATASETS["avenue"] is before
    assert (tmp_path / "results" / "avenue" / "score_masks.npy").exists()
