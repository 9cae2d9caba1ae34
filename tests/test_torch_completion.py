"""STC extraction and the two-stream completion ensemble in the port,
held against vec_vad_tpu on the same inputs and converted weights; and a
.npz model saved by vec_vad_tpu loading in the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from vec_vad_torch.config import CompletionConfig as TCompletionConfig
from vec_vad_torch.models.completion import make_completion_net as t_make
from vec_vad_torch.models.convert import completion_from_jax
from vec_vad_torch.ops import stc as tstc
from vec_vad_torch.runtime.artifacts import load_vad_model
from vec_vad_tpu.config import CompletionConfig, ForegroundConfig, PipelineConfig
from vec_vad_tpu.models.completion import make_completion_net as j_make
from vec_vad_tpu.ops import stc as jstc
from vec_vad_tpu.pipeline import VadModel
from vec_vad_tpu.runtime.artifacts import save_vad_model
from vec_vad_tpu.train.trainer import TrainedBlock


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _window_and_boxes(seed, T=5, H=48, W=64, C=3, K=8):
    rng = np.random.default_rng(seed)
    window = rng.integers(0, 256, (T, H, W, C), dtype=np.uint8)
    x0 = rng.uniform(-3, W - 4, K)
    y0 = rng.uniform(-3, H - 4, K)
    boxes = np.stack(
        [x0, y0, x0 + rng.uniform(0, 30, K), y0 + rng.uniform(0, 30, K)], 1
    ).astype(np.float32)
    boxes[0] = (5.2, 7.9, 5.2, 20.0)  # degenerate width: samples column lo
    boxes[1] = (0.0, 0.0, W, H)  # the whole frame
    return window, boxes


@pytest.mark.parametrize("patch", [16, 32])
def test_extract_stc_matches_jax(patch):
    window, boxes = _window_and_boxes(0)
    tw, tb = torch.from_numpy(window), torch.from_numpy(boxes)
    got = tstc.extract_stc(tw, tb, patch).numpy()
    want = np.asarray(jstc.extract_stc(jnp.asarray(window), jnp.asarray(boxes),
                                       patch))
    assert got.shape == (8, 5, patch, patch, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # quantized: within 1 LSB (the JAX package's own cv2 bound, PARITY.md)
    gq = tstc.extract_stc(tw, tb, patch, quantize=True).numpy()
    wq = np.asarray(jstc.extract_stc(jnp.asarray(window), jnp.asarray(boxes),
                                     patch, quantize=True))
    assert np.max(np.abs(gq - wq)) <= 1.0
    one = tstc.crop_resize_cube(tw, tb[3], patch).numpy()
    np.testing.assert_array_equal(one, got[3])


def test_cube_to_input_and_flow_magnitude_match_jax():
    rng = np.random.default_rng(1)
    cubes = rng.normal(size=(6, 5, 16, 16, 2)).astype(np.float32)
    tc = torch.from_numpy(cubes)
    for scale in (False, True):
        np.testing.assert_array_equal(
            tstc.cube_to_input(tc, scale).numpy(),
            np.asarray(jstc.cube_to_input(jnp.asarray(cubes), scale)),
        )
    np.testing.assert_allclose(
        tstc.flow_magnitude(tc).numpy(),
        np.asarray(jstc.flow_magnitude(jnp.asarray(cubes))), rtol=1e-6,
    )


def _jax_ensemble(seed, nf=4, P=16, K=6, context_of_num=0):
    """A JAX 5raw1of ensemble with random weights AND random BN running
    statistics (init leaves them at 0/1, which would hide a mapping slip),
    plus a seeded batch of raw/flow cube inputs."""
    cfg = CompletionConfig(nf=nf, context_of_num=context_of_num, use_flow=True)
    net = j_make(cfg)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (K, P, P, 3 * cfg.tot_raw_num)).astype(np.float32)
    x_of = rng.normal(size=(K, P, P, 2 * cfg.tot_of_num)).astype(np.float32)
    v = net.init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(x_of), False)
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    for ens in stats.values():
        for dc in ens.values():
            for bn in dc.values():
                bn["mean"] = rng.normal(0, 0.2, bn["mean"].shape).astype(np.float32)
                bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    params = jax.tree.map(np.asarray, v["params"])
    return cfg, net, params, stats, x, x_of


@pytest.mark.parametrize("context_of_num", [0, 4])
def test_ensemble_matches_jax(context_of_num):
    """5raw1of (and 5raw5of) in eval mode, nf=4, patch 16: raw and flow
    outputs and the per-cube scores within 1e-5 relative."""
    cfg, jnet, params, stats, x, x_of = _jax_ensemble(3, context_of_num=context_of_num)
    jout = jnet.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), jnp.asarray(x_of), False)
    tnet = t_make(TCompletionConfig(nf=4, context_of_num=context_of_num,
                                    use_flow=True), device="cpu")
    tnet.load_state_dict(completion_from_jax(params, stats), strict=True)
    assert tnet.flow_positions == jnet.flow_positions
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x), torch.from_numpy(x_of))
    for name in ("raw_out", "raw_tgt", "of_out", "of_tgt"):
        g, w = getattr(tout, name).numpy(), np.asarray(getattr(jout, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)

    def scores(o, np_):
        raw = np.sum(np.square(np_(o.raw_out) - np_(o.raw_tgt)), axis=(0, 2, 3, 4))
        of = np.sum(np.square(np_(o.of_out) - np_(o.of_tgt)), axis=(0, 2, 3, 4))
        return raw, of

    for g, w in zip(scores(tout, lambda t: t.numpy()), scores(jout, np.asarray)):
        np.testing.assert_allclose(g, w, rtol=1e-5)


def test_npz_model_from_jax_loads_in_port(tmp_path):
    """A VadModel saved by vec_vad_tpu serves in the port: config, score
    statistics and converted weights all carry over."""
    cfg_m, _, params, stats, _, _ = _jax_ensemble(5)
    cfg = PipelineConfig(fore=ForegroundConfig(patch_size=16, h_block=2),
                         model=cfg_m)
    rng = np.random.default_rng(6)
    blocks = {
        (0, 0, 0): TrainedBlock(params, stats, rng.normal(size=9), rng.normal(size=9)),
        (0, 1, 0): TrainedBlock(params, stats, rng.normal(size=7), None),
    }
    path = str(tmp_path / "model.npz")
    save_vad_model(path, VadModel(cfg=cfg, blocks=blocks))

    model = load_vad_model(path)
    assert sorted(model.blocks) == sorted(blocks)
    assert model.cfg.fore.h_block == 2 and model.cfg.model.nf == 4
    assert model.cfg.model.tot_of_num == cfg.model.tot_of_num
    want_sd = completion_from_jax(params, stats)
    for key, blk in blocks.items():
        got = model.blocks[key]
        assert got.raw_stats == pytest.approx(blk.raw_stats)
        assert (got.of_stats is None) == (blk.of_stats is None)
        assert sorted(got.state_dict) == sorted(want_sd)
        for k in want_sd:
            torch.testing.assert_close(got.state_dict[k], want_sd[k], rtol=0, atol=0)
    net = t_make(model.cfg.model, device="cpu")
    net.load_state_dict(model.blocks[(0, 0, 0)].state_dict, strict=True)
