"""The reference's model_set in and out of the port — models.
completion_convert / completion_export and the import-torch / export-torch
CLI — held against vec_vad_tpu's converters on the same numpy-seeded
weights: the port's export loads in the JAX package's import and the other
way round, both score alike, and the port's own round trip is bit for bit
(nf=4, patch 16)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
from vec_vad_torch import cli as t_cli
from vec_vad_torch import config as t_config
from vec_vad_torch import pipeline as t_pipe
from vec_vad_torch.models import completion_convert as t_conv
from vec_vad_torch.models import completion_export as t_exp
from vec_vad_torch.models.completion import make_completion_net as t_make_net
from vec_vad_torch.models.convert import completion_from_jax
from vec_vad_torch.runner import model_path
from vec_vad_torch.runtime.artifacts import load_vad_model, save_vad_model
from vec_vad_tpu import config as j_config
from vec_vad_tpu import pipeline as j_pipe
from vec_vad_tpu.models import completion_convert as j_conv
from vec_vad_tpu.models import completion_export as j_exp
from vec_vad_tpu.models.completion import make_completion_net as j_make_net

P, NF = 16, 4
FILES = ("model", "raw_training_scores", "of_training_scores")
# the same weights scored in either package (PARITY.md:26)
CROSS_REL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(dataset="UCSDped2", hw=(2, 1), use_flow=True, context_of_num=0):
    out = []
    for c in (j_config, t_config):
        out.append(c.PipelineConfig(
            dataset_name=dataset,
            fore=c.ForegroundConfig(patch_size=P, h_block=hw[0], w_block=hw[1]),
            model=c.CompletionConfig(nf=NF, context_of_num=context_of_num,
                                     use_flow=use_flow),
        ))
    return out


def _variables(jcfg, seed):
    """JAX init variables for the config with running statistics moved off
    (0, 1), as numpy trees (tests/test_export.py's _init_variables)."""
    net = j_make_net(jcfg.model)
    tot_of = jcfg.model.tot_of_num
    v = net.init(jax.random.key(seed), np.zeros((1, P, P, 15), np.float32),
                 np.zeros((1, P, P, 2 * tot_of), np.float32), False)
    v = jax.tree.map(np.asarray, v)
    rng = np.random.default_rng(seed + 10)
    v["batch_stats"] = jax.tree.map(
        lambda x: np.abs(x + 0.05 * rng.standard_normal(x.shape).astype(x.dtype)),
        v["batch_stats"])
    return v


def _models(jcfg, tcfg, keys, with_of=True):
    """The same blocks in both packages: JAX variables from seeds and the
    port's state dicts from them; seeded training scores."""
    rng = np.random.default_rng(7)
    jm, tm = j_pipe.VadModel(cfg=jcfg), t_pipe.VadModel(cfg=tcfg)
    for i, key in enumerate(keys):
        v = _variables(jcfg, i)
        raw = (rng.random(13) * 50).astype(np.float32)
        of = (rng.random(13) * 5).astype(np.float32) if with_of else None
        jm.blocks[key] = j_pipe.TrainedBlock(params=v["params"],
                                             batch_stats=v["batch_stats"],
                                             raw_scores=raw, of_scores=of)
        tm.blocks[key] = t_pipe.TrainedBlock(
            state_dict=completion_from_jax(v["params"], v["batch_stats"]),
            raw_scores=raw, of_scores=of)
    return jm, tm


def _test_cubes(cfg, n=40):
    """Seeded uint8 (and flow) test cubes in cells (0, 0), (1, 0) and the
    untrained (1, 1)."""
    rng = np.random.default_rng(3)
    cells = np.zeros((n, 2), np.int64)
    cells[n // 3:, 0] = 1
    cells[-5:, 1] = 1
    tot_of = cfg.model.tot_of_num
    return dict(raw=rng.integers(0, 256, (n, P, P, 15), dtype=np.uint8),
                flow=rng.normal(0, 0.1, (n, P, P, 2 * tot_of)).astype(np.float32)
                if cfg.model.use_flow else None,
                frame_ids=np.arange(n), boxes=np.zeros((n, 4), np.float32),
                cells=cells, scenes=np.ones(n, np.int64))


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


def _scores_alike(jm, tm):
    """score_cubes of the JAX model in JAX and of the port model in the port
    on the same cubes: within 2e-4 of the largest finite score, the
    untrained cell's big_number rows equal."""
    kw = _test_cubes(tm.cfg)
    want = j_pipe.score_cubes(jm, j_pipe.CubeSet(**kw))
    got = t_pipe.score_cubes(tm, t_pipe.CubeSet(**kw), device="cpu")
    big = want == t_pipe.BIG_NUMBER
    assert big.sum() == 5
    np.testing.assert_array_equal(got == t_pipe.BIG_NUMBER, big)
    assert _rel(got[~big], want[~big]) <= CROSS_REL


def _equal_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("context_of_num", [0, 4])
def test_export_state_dict_equals_jax_export(context_of_num):
    """The port's reference-format state dict of the same weights equals
    the JAX package's export key for key and bit for bit, 'module.' prefix
    and num_batches_tracked included: Net4's shared flow UNet (5raw1of)
    and Full's per-slot ones (5raw5of); and the port's import reads the
    JAX export back to the same weights."""
    jcfg, tcfg = _configs(context_of_num=context_of_num)
    v = _variables(jcfg, 0)
    want = j_exp.export_completion_state_dict(v, j_make_net(jcfg.model))
    net = t_make_net(tcfg.model, "cpu")
    got = t_exp.export_completion_state_dict(completion_from_jax(v["params"],
                                                                 v["batch_stats"]), net)
    _equal_state(got, want)
    _equal_state(t_conv.convert_completion_state_dict(want, net),
                 completion_from_jax(v["params"], v["batch_stats"]))


@pytest.mark.parametrize("use_flow", [True, False])
def test_port_export_loads_in_jax_import(tmp_path, use_flow):
    """export_model_grid of the port, import_model_grid of the JAX package:
    the same file names, the weights equal after conversion, the training
    scores bit for bit, and both models score alike."""
    jcfg, tcfg = _configs(use_flow=use_flow)
    _, tm = _models(jcfg, tcfg, [(0, 0, 0), (0, 1, 0)], with_of=use_flow)
    paths = t_exp.export_model_grid(tm, str(tmp_path), device="cpu")
    assert [os.path.basename(p) for p in paths] == [
        f"UCSDped2_{f}_obj_det_with_motion_SelfComplete.npy" for f in FILES]
    back = j_conv.import_model_grid(jcfg, str(tmp_path))
    assert sorted(back.blocks) == sorted(tm.blocks)
    for key, blk in tm.blocks.items():
        got = back.blocks[key]
        _equal_state(completion_from_jax(got.params, got.batch_stats), blk.state_dict)
        np.testing.assert_array_equal(got.raw_scores, blk.raw_scores)
        if use_flow:
            np.testing.assert_array_equal(got.of_scores, blk.of_scores)
        else:
            assert got.of_scores is None
    _scores_alike(back, tm)


def test_jax_export_loads_in_port_import(tmp_path):
    """export_model_grid of the JAX package, import_model_grid of the port:
    the weights the JAX blocks' converted bit for bit, the statistics'
    arrays equal, and the imported model scores within 2e-4 of JAX's."""
    jcfg, tcfg = _configs()
    jm, tm = _models(jcfg, tcfg, [(0, 0, 0), (0, 1, 0)])
    j_exp.export_model_grid(jm, str(tmp_path))
    back = t_conv.import_model_grid(tcfg, str(tmp_path), device="cpu")
    assert sorted(back.blocks) == sorted(jm.blocks)
    for key, blk in tm.blocks.items():
        _equal_state(back.blocks[key].state_dict, blk.state_dict)
        np.testing.assert_array_equal(back.blocks[key].raw_scores, blk.raw_scores)
        np.testing.assert_array_equal(back.blocks[key].of_scores, blk.of_scores)
    _scores_alike(jm, back)


def test_port_round_trip_bit_for_bit(tmp_path):
    """The port's export then its import: block keys, weights, running
    statistics and both training-score arrays bit for bit, and the
    reloaded model's cube scores equal the original's."""
    _, tcfg = _configs()
    _, tm = _models(*_configs(), [(0, 0, 0), (0, 1, 0)])
    t_exp.export_model_grid(tm, str(tmp_path), device="cpu")
    back = t_conv.import_model_grid(tcfg, str(tmp_path), device="cpu")
    assert list(back.blocks) == sorted(tm.blocks)
    for key, blk in tm.blocks.items():
        _equal_state(back.blocks[key].state_dict, blk.state_dict)
        np.testing.assert_array_equal(back.blocks[key].raw_scores, blk.raw_scores)
        np.testing.assert_array_equal(back.blocks[key].of_scores, blk.of_scores)
    cubes = t_pipe.CubeSet(**_test_cubes(tcfg))
    np.testing.assert_array_equal(t_pipe.score_cubes(back, cubes, device="cpu"),
                                  t_pipe.score_cubes(tm, cubes, device="cpu"))


def _nested_equal(a, b):
    """The same nesting of lists, state dicts and score arrays."""
    if isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _nested_equal(x, y)
    elif isinstance(b, dict):
        _equal_state(a, b)
    else:
        np.testing.assert_array_equal(a, b)


def test_multiscene_raw_only_grid_like_jax(tmp_path):
    """A ShanghaiTech-style raw-only model (JAX: tests/test_export.py:
    184-278): the port writes the JAX package's three files to the same
    nesting ([scene][h][w], scenes up to the largest key, [] untrained
    cells, an of-score grid of [] only) and contents, both imports read
    back the (scene, h, w) keys with of_scores None, and a key outside
    the grid or a second scene in a single-scene dataset raises."""
    jcfg, tcfg = _configs("ShanghaiTech", (1, 1), use_flow=False)
    jm, tm = _models(jcfg, tcfg, [(2, 0, 0)], with_of=False)
    t_paths = t_exp.export_model_grid(tm, str(tmp_path / "t"), device="cpu")
    j_paths = j_exp.export_model_grid(jm, str(tmp_path / "j"))
    for tp, jp in zip(t_paths, j_paths):
        assert os.path.basename(tp) == os.path.basename(jp)
        _nested_equal(torch.load(tp, weights_only=False), torch.load(jp, weights_only=False))
    ms = torch.load(t_paths[0], weights_only=False)
    assert len(ms) == 3 and ms[0][0][0] == [] and len(ms[2][0][0]) == 1
    for back in (t_conv.import_model_grid(tcfg, str(tmp_path / "j"), device="cpu"),
                 j_conv.import_model_grid(jcfg, str(tmp_path / "t"))):
        assert set(back.blocks) == {(2, 0, 0)}
        assert back.blocks[(2, 0, 0)].of_scores is None
    bad = dataclasses.replace(tm, blocks={(0, 1, 0): tm.blocks[(2, 0, 0)]})
    with pytest.raises(ValueError, match="outside"):
        t_exp.export_model_grid(bad, str(tmp_path / "bad"), device="cpu")
    _, single = _configs(use_flow=False)
    with pytest.raises(ValueError, match="single-scene"):
        t_exp.export_model_grid(dataclasses.replace(tm, cfg=single),
                                str(tmp_path / "bad"), device="cpu")


def test_import_export_cli(tmp_path, capsys):
    """export-torch then import-torch through cli.main with --device cpu:
    the .npz model under --base goes out as the reference's files and comes
    back to an .npz equal to it; both subcommands and demo are in --help."""
    _, tcfg = _configs()
    _, tm = _models(*_configs(), [(0, 0, 0), (0, 1, 0)])
    ini = tmp_path / "config.cfg"
    ini.write_text("[shared_parameters]\ndataset_name = UCSDped2\n"
                   f"[UCSDped2]\npatch_size = {P}\nh_block = 2\nw_block = 1\n"
                   f"[SelfComplete]\nnf = {NF}\ncontext_of_num = 0\nuseFlow = True\n")
    cfg = t_config.load_ini_config(str(ini))
    assert cfg.fore.h_block == 2 and cfg.model.use_flow
    src, dst = tmp_path / "src", tmp_path / "dst"
    path = model_path(cfg, str(src))
    os.makedirs(os.path.dirname(path))
    save_vad_model(path, dataclasses.replace(tm, cfg=cfg))
    out = tmp_path / "ref"
    assert t_cli.main(["export-torch", "--config", str(ini), "--base", str(src),
                       "--out", str(out), "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == sorted(
        f"UCSDped2_{f}_obj_det_with_motion_SelfComplete.npy" for f in FILES)
    assert t_cli.main(["import-torch", "--config", str(ini), "--base", str(dst),
                       "--model-dir", str(out), "--device", "cpu"]) == 0
    assert "imported 2 block(s)" in capsys.readouterr().out
    back = load_vad_model(model_path(cfg, str(dst)))
    for key, blk in tm.blocks.items():
        _equal_state(back.blocks[key].state_dict, blk.state_dict)
        np.testing.assert_array_equal(back.blocks[key].of_scores, blk.of_scores)
    with pytest.raises(SystemExit):
        t_cli.main(["--help"])
    helptext = capsys.readouterr().out
    for cmd in ("demo", "export-torch", "import-torch"):
        assert cmd in helptext
