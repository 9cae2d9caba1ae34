"""The routes whose replicas never talk, over the port's device mesh
["cpu", "cpu"]: calc-flow's pairs, the camera fleets (precomputed and
live flow) and the model grid's blocks, each held to the port's
one-device run and to vec_vad_tpu's route on a 2-device mesh
(get_mesh(jax.devices()[:2])) on the same inputs and weights.

Sizes and stand-ins are the one-device tests': the TinyFlow twin at
16x24 for FlowNet2 (tests/test_torch_calc_flow.py), the nf=4 patch-16
.npz models of tests/test_torch_serving.py, random uint8 blocks for the
grid (tests/test_torch_cuda.py's counts)."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_calc_flow import (
    ATOL,
    DATASET,
    HW,
    MODEL_HW,
    _frames,
    _read_tree,
    _register,
    _tree,
)
from test_torch_mesh import LOSS_REL, WEIGHT_ATOL
from test_torch_serving import FLOW_HW, TinyFlow, TorchTinyFlow, _models
from test_torch_serving_surface import TOL, _fleet_feed
from vec_vad_torch import cli as t_cli
from vec_vad_torch import config as t_config
from vec_vad_torch import parallel as t_par
from vec_vad_torch import runner as t_runner
from vec_vad_torch.data import video_index as t_vi
from vec_vad_torch.flow import driver as t_driver
from vec_vad_torch.models.convert import completion_from_jax
from vec_vad_torch.serve import MultiCameraFlowScorer as TFlowFleet
from vec_vad_torch.serve import MultiCameraScorer as TFleet
from vec_vad_torch.train import grid_trainer as t_grid
from vec_vad_tpu import config as j_config
from vec_vad_tpu import pipeline as j_pipe
from vec_vad_tpu.data import video_index as j_vi
from vec_vad_tpu.data.synthetic import make_synthetic_dataset
from vec_vad_tpu.flow import driver as j_driver
from vec_vad_tpu.parallel.mesh import get_mesh
from vec_vad_tpu.serve import MultiCameraFlowScorer as JFlowFleet
from vec_vad_tpu.serve import MultiCameraScorer as JFleet
from vec_vad_tpu.train import grid_trainer as j_grid

MESH = ["cpu", "cpu"]
# the grid's training scores, relative to each block's largest: the JAX
# package's whole-pipeline bound, tests/test_torch_grid.py's. Folding 2 + 1
# blocks in place of 3 changes the grouped convolutions' summation order,
# so losses and weights are held as tests/test_torch_mesh.py holds them
GRID_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _jax_mesh():
    return get_mesh(jax.devices()[:2])


@pytest.fixture(scope="module")
def flow_nets():
    net = TinyFlow()
    v = net.init(jax.random.key(3), jnp.zeros((1, 2) + MODEL_HW + (3,)))
    return net, v, TorchTinyFlow(v)


# ---------------------------------------------------------------------------
# calc-flow
# ---------------------------------------------------------------------------


def test_calc_flow_on_mesh_matches_one_device_and_jax(flow_nets):
    """The resident and segmented drivers with the pairs over two
    replicas (13 frames in videos of 6, 4 and 3, chunk 3: shares of 6 and
    7 pairs, each ending in a short batch): the one-device maps and JAX's
    meshed resident route within atol 1e-5; the non-resident route keeps
    to one device, as JAX's does."""
    jnet, jv, tnet = flow_nets
    lengths = np.array([6, 4, 3])
    frames = _frames(int(lengths.sum()), seed=4)
    tidx, jidx = (m.VideoIndex(["a", "b", "c"], lengths) for m in (t_vi, j_vi))
    kw = dict(chunk=3, model_hw=MODEL_HW)
    want = j_driver.compute_optical_flow(jnet, jv, jidx, frames, resident=True,
                                         mesh=_jax_mesh(), **kw)
    one = t_driver.compute_optical_flow(tnet, tidx, frames, resident=True,
                                        device="cpu", **kw)
    got = t_driver.compute_optical_flow(tnet, tidx, frames, resident=True,
                                        device="cpu", mesh=MESH, **kw)
    assert got.shape == (13,) + HW + (2,) and np.abs(got).max() > 0.01
    np.testing.assert_allclose(got, one, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    calls = []
    real = t_driver._run_pairs_mesh
    t_driver._run_pairs_mesh = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        per_chunk = t_driver.compute_optical_flow(tnet, tidx, frames, device="cpu",
                                                  mesh=MESH, **kw)
        seg = {}
        n = t_driver.compute_optical_flow_segmented(
            tnet, tidx, frames, lambda i, f: seg.__setitem__(i, f), segment_frames=4,
            device="cpu", mesh=MESH, **kw)
    finally:
        t_driver._run_pairs_mesh = real
    np.testing.assert_allclose(per_chunk, one, rtol=0, atol=ATOL)
    # segments of 4 frames round up to chunk * entries = 6: 3 segments
    assert n == 13 and sorted(seg) == list(range(13)) and len(calls) == 3
    np.testing.assert_allclose(np.stack([seg[i] for i in range(13)]), one,
                               rtol=0, atol=ATOL)


def test_run_calc_flow_use_mesh_and_cli(tmp_path, monkeypatch, flow_nets):
    """run_calc_flow's use_mesh branch, with get_mesh standing in for a
    machine of two cards ("cpu" twice), asks get_mesh for the caller's
    device, runs the pairs over both entries and writes the one-device
    tree; use_mesh=False (`calc-flow --no-mesh`, and without the flag
    True) never asks for a mesh."""
    _register(monkeypatch)
    base = str(tmp_path)
    _tree(base, {"Train": [5, 2], "Test": [4]})
    tnet = flow_nets[2]
    monkeypatch.setattr(t_runner, "make_flownet2", lambda seed, device: tnet)
    asked, replicas = [], []
    monkeypatch.setattr(t_runner, "get_mesh",
                        lambda device: asked.append(device) or t_par.get_mesh(MESH))
    real = t_driver._run_pairs_mesh
    monkeypatch.setattr(t_driver, "_run_pairs_mesh",
                        lambda nets, *a, **k: replicas.append(len(nets))
                        or real(nets, *a, **k))
    cfg = t_config.PipelineConfig(dataset_name=DATASET)
    t_runner.run_calc_flow(cfg, base, segment_frames=3, device="cpu")
    got = _read_tree(os.path.join(base, "optical_flow", DATASET))
    assert asked == ["cpu"] and replicas and set(replicas) == {2}
    n_mesh = len(replicas)
    cfg_one = t_config.PipelineConfig(dataset_name=DATASET, optical_flow_dir="of_one")
    t_runner.run_calc_flow(cfg_one, base, segment_frames=3, device="cpu",
                           use_mesh=False)
    assert asked == ["cpu"] and len(replicas) == n_mesh
    want = _read_tree(os.path.join(base, "of_one", DATASET))
    assert sorted(got) == sorted(want) and len(got) == 11
    for rel, w in want.items():
        np.testing.assert_allclose(got[rel], w, rtol=0, atol=ATOL, err_msg=rel)

    cfg_path = str(tmp_path / "c.cfg")
    with open(cfg_path, "w") as f:
        f.write(f"[shared_parameters]\ndataset_name = {DATASET}\n")
    seen = []
    monkeypatch.setattr(t_runner, "run_calc_flow",
                        lambda *a, **k: seen.append(k["use_mesh"]))
    argv = ["calc-flow", "--config", cfg_path, "--base", base, "--device", "cpu"]
    assert t_cli.main(argv + ["--no-mesh"]) == 0 and t_cli.main(argv) == 0
    assert seen == [False, True]


# ---------------------------------------------------------------------------
# the camera fleets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def split():
    ds = make_synthetic_dataset(frames_per_video=8, n_train_videos=1,
                                n_test_videos=2, frame_h=48, frame_w=64, seed=23)
    flows = np.random.default_rng(9).normal(
        0, 1.5, ds.test_frames.shape[:3] + (2,)).astype(np.float32)
    return ds.test_frames, ds.test_boxes, flows


def test_fleet_on_mesh_matches_one_device_and_jax(tmp_path, split):
    """MultiCameraScorer at C = 4 over two entries (2 cameras each, rings
    and weights of their own): camera 3 cut to a new video mid-stream,
    flows streamed except on one tick, pipeline_depth 1; every tick
    against the one-device fleet and JAX's fleet on its 2-device mesh."""
    jmodel, tmodel = _models(tmp_path, 31)
    kw = dict(n_cameras=4, pipeline_depth=1)
    js = JFleet.from_model(jmodel, mesh=_jax_mesh(), **kw)
    one = TFleet.from_model(tmodel, device="cpu", **kw)
    ts = TFleet.from_model(tmodel, mesh=MESH, **kw)
    assert ts.device.type == "cpu" and len(ts._replicas) == 2
    assert ts._replicas[1]._forwards[0] is not ts._forwards[0]

    def run(sc):
        out = []
        sc.start_video()
        for t, (f, b, fl) in enumerate(_fleet_feed(split, 7, 4)):
            if t == 3:
                sc.start_video(camera=3)
            out.append(sc.push_tick(f, b, flows=None if t == 5 else fl))
        return [o for o in out if o is not None] + sc.drain()

    got = np.asarray(run(ts))
    assert got.shape == (7, 4) and len(np.unique(got)) > 10
    assert ts._replicas[1]._ring.shape[0] == 2
    np.testing.assert_allclose(got, np.asarray(run(one)), **TOL)
    np.testing.assert_allclose(got, np.asarray(run(js)), **TOL)
    frames, boxes, _ = zip(*_fleet_feed(split, 1, 4))
    assert ts.time_device_tick(frames[0], boxes[0], k=2, repeats=1) > 0


def test_live_fleet_on_mesh_matches_one_device_and_jax(tmp_path, split):
    """MultiCameraFlowScorer at C = 4 over two entries, a TinyFlow replica
    each: a 4-frame video then a 2-frame one; every emitted tick against
    the one-device live fleet and JAX's on its 2-device mesh."""
    net = TinyFlow()
    jv = net.init(jax.random.key(7), jnp.zeros((1, 2) + FLOW_HW + (3,)))
    tnet = TorchTinyFlow(jv)
    jmodel, tmodel = _models(tmp_path, 32)
    kw = dict(n_cameras=4, flow_model_hw=FLOW_HW)
    js = JFlowFleet.from_model(jmodel, flow_net=net, flow_variables=jv,
                               mesh=_jax_mesh(), **kw)
    one = TFlowFleet.from_model(tmodel, flow_net=tnet, device="cpu", **kw)
    ts = TFlowFleet.from_model(tmodel, flow_net=tnet, mesh=MESH, **kw)
    assert ts._replicas[1].flow_net is not ts.flow_net
    feed = _fleet_feed(split, 6, 4)

    def run(sc):
        out = []
        for lo, hi in ((0, 4), (4, 6)):
            sc.start_video()
            out += [sc.push_tick(f, b) for f, b, _ in feed[lo:hi]]
            out.append(sc.end_video())
        return out

    got, want = run(ts), run(one)
    assert [o is None for o in got] == [o is None for o in want]
    got = np.asarray([o for o in got if o is not None])
    assert got.shape == (6, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, [o for o in want if o is not None], **TOL)
    jax_out = [o for o in run(js) if o is not None]
    np.testing.assert_allclose(got, jax_out, **TOL)


def test_fleet_must_divide_over_the_mesh(tmp_path):
    """C = 3 over two entries: JAX's ValueError, from both fleets."""
    jmodel, tmodel = _models(tmp_path, 33)
    with pytest.raises(ValueError, match="divide evenly"):
        JFleet.from_model(jmodel, n_cameras=3, mesh=_jax_mesh())
    for fleet, kw in ((TFleet, {}), (TFlowFleet, {"flow_net": TorchTinyFlow(
            TinyFlow().init(jax.random.key(0), jnp.zeros((1, 2) + FLOW_HW + (3,)))),
            "flow_model_hw": FLOW_HW})):
        with pytest.raises(ValueError, match="divide evenly"):
            fleet.from_model(tmodel, n_cameras=3, mesh=MESH, **kw)


# ---------------------------------------------------------------------------
# the model grid
# ---------------------------------------------------------------------------


def _grid_configs():
    kw = dict(nf=4, epochs=2, batch_size=16, context_frame_num=4, context_of_num=0,
              use_flow=False)
    return [c.PipelineConfig(dataset_name="UCSDped2",
                             fore=c.ForegroundConfig(patch_size=16, max_boxes_per_frame=8),
                             model=c.CompletionConfig(**kw))
            for c in (j_config, t_config)]


def _grid_data():
    rng = np.random.default_rng(12)
    keys = ((0, 0, 0), (0, 0, 1), (0, 1, 0))
    return [(k, rng.integers(0, 256, (n, 16, 16, 15), dtype=np.uint8), None)
            for k, n in zip(keys, (40, 25, 7))]


def test_grid_on_mesh_matches_jax_and_one_device():
    """GridTrainer with 3 blocks over two entries (2 + 1 blocks, each
    entry folding its own share): every block's training scores against
    JAX's GridTrainer on its 2-device mesh (1e-3 of the largest) and its
    weights, losses and scores against the port's one-device grid; the
    folded scoring over the mesh equals the one-device scoring."""
    jcfg, tcfg = _grid_configs()
    jt = j_pipe.make_trainer(jcfg, _jax_mesh())
    st = jt.init_state(0)
    init = completion_from_jax(jax.tree.map(np.asarray, st.params),
                               jax.tree.map(np.asarray, st.batch_stats))
    data = _grid_data()
    jb = j_grid.get_grid_trainer(jt.net, jcfg.model, _jax_mesh(), 16).fit_blocks(
        data, seed=0)
    gt = t_grid.GridTrainer(tcfg.model, 16, mesh=MESH)
    assert [len(share) for _, share in gt._shares(data)] == [2, 1]
    tb = gt.fit_blocks(data, seed=0, init_state=init)
    ob = t_grid.GridTrainer(tcfg.model, 16, "cpu").fit_blocks(data, seed=0,
                                                             init_state=init)
    assert list(tb) == [k for k, _, _ in data]
    for key, raw, _ in data:
        t, o = tb[key], ob[key]
        assert t.losses.shape == (2 * -(-raw.shape[0] // 16),)
        np.testing.assert_allclose(t.losses, o.losses, rtol=LOSS_REL)
        for want in (o.raw_scores, np.asarray(jb[key].raw_scores)):
            assert np.max(np.abs(t.raw_scores - want)) <= GRID_REL * np.max(np.abs(want))
        for k, v in t.state_dict.items():
            np.testing.assert_allclose(v.numpy(), o.state_dict[k].numpy(), rtol=0,
                                       atol=WEIGHT_ATOL, err_msg=f"{key} {k}")
    test = [(k, raw[::-1].copy(), None) for k, raw, _ in data]
    got = gt.score_blocks(tb, test)
    want = t_grid.GridTrainer(tcfg.model, 16, "cpu").score_blocks(tb, test)
    for key in got:
        np.testing.assert_allclose(got[key][0], want[key][0], rtol=LOSS_REL)
