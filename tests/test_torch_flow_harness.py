"""The port's flow harness and CLI on a FlyingChairs-layout fixture: resume
reproduces the uninterrupted run, model_best reloads to its EPE, infer's
.flo files reproduce its EPE, the copied datasets batch byte for byte
like vec_vad_tpu's, and `python -m vec_vad_torch flow-train/flow-infer`
train and refuse as vec_vad_tpu's CLI does."""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

cv2 = pytest.importorskip("cv2")

from vec_vad_torch import cli as tcli  # noqa: E402
from vec_vad_torch.flow.datasets import FlyingChairs as TChairs  # noqa: E402
from vec_vad_torch.flow.harness import FlowHarness  # noqa: E402
from vec_vad_torch.flow.trainer import FlowTrainer  # noqa: E402
from vec_vad_torch.utils.flowviz import read_flo, write_flo  # noqa: E402
from vec_vad_tpu import cli as jcli  # noqa: E402
from vec_vad_tpu.flow.datasets import FlyingChairs as JChairs  # noqa: E402
from vec_vad_tpu.utils import flowviz as jflowviz  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class TinyPyramidNet(nn.Module):
    """A 5-scale pyramid net with the FlowNet output contract (flow2..flow6
    at 1/4..1/64), seeded from numpy; the harness is net-agnostic."""

    def __init__(self, seed=0):
        super().__init__()
        self.down = nn.ModuleList(nn.Conv2d(6 if k == 0 else 8, 8, 3, 2, 1)
                                  for k in range(6))
        self.heads = nn.ModuleList(nn.Conv2d(8, 2, 3, 1, 1) for _ in range(5))
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.from_numpy(
                    rng.uniform(-0.2, 0.2, p.shape).astype(np.float32)))

    def forward(self, pairs, train: bool = False):
        feats, pyramid = pairs.permute(0, 3, 1, 2) / 255.0, []
        for k, conv in enumerate(self.down):
            feats = F.relu(conv(feats))
            if k >= 1:
                pyramid.append(self.heads[k - 1](feats).permute(0, 2, 3, 1))
        return pyramid


@pytest.fixture(scope="module")
def chairs_dir(tmp_path_factory):
    """FlyingChairs-layout fixture: smooth textures shifted by a constant
    (4, 0) flow, 64x64 (tests/test_flow_harness.py's)."""
    root = tmp_path_factory.mktemp("chairs")
    rng = np.random.default_rng(0)
    h = w = 64
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(10):
        phase = rng.uniform(0, 6.28, 3)
        img = np.stack(
            [127 + 100 * np.sin(xx / 5.0 + phase[c]) * np.cos(yy / 7.0)
             for c in range(3)], axis=-1,
        ).astype(np.uint8)
        cv2.imwrite(str(root / f"{i:05d}-img_0.ppm"), img)
        cv2.imwrite(str(root / f"{i:05d}-img_1.ppm"), np.roll(img, 4, axis=1))
        flow = np.zeros((h, w, 2), np.float32)
        flow[..., 0] = 4.0
        write_flo(str(root / f"{i:05d}-flow.flo"), flow)
    return str(root)


def _harness(workdir):
    trainer = FlowTrainer(TinyPyramidNet(), learning_rate=2e-3,
                          schedule_lr_frequency=3, device="cpu")
    return FlowHarness(trainer, workdir)


def test_resume_reproduces_the_uninterrupted_run(chairs_dir, tmp_path):
    """Stopping after epoch 2 and restarting with fresh objects on the same
    workdir gives the 4-epoch run's weights, Adam state and val EPE."""
    ds = TChairs(chairs_dir)
    full_h = _harness(str(tmp_path / "full"))
    full = full_h.fit(ds, ds, total_epochs=4, batch_size=4, seed=0)
    assert [h["epoch"] for h in full.history] == [1, 2, 3, 4]
    assert full.history[-1]["val_epe"] < full.history[0]["val_epe"]

    _harness(str(tmp_path / "resume")).fit(ds, ds, total_epochs=2, batch_size=4, seed=0)
    resumed_h = _harness(str(tmp_path / "resume"))
    resumed = resumed_h.fit(ds, ds, total_epochs=4, batch_size=4, seed=0)
    assert [h["epoch"] for h in resumed.history] == [3, 4]
    assert resumed.history[-1]["val_epe"] == pytest.approx(
        full.history[-1]["val_epe"], rel=1e-6)
    assert resumed_h.trainer.step_count == full_h.trainer.step_count == 12
    for a, b in zip(full_h.trainer.net.parameters(),
                    resumed_h.trainer.net.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_model_best_reloads_to_its_epe(chairs_dir, tmp_path):
    ds = TChairs(chairs_dir)
    h = _harness(str(tmp_path / "run"))
    result = h.fit(ds, ds, total_epochs=3, batch_size=5, seed=1)
    assert result.best_epe == min(e["val_epe"] for e in result.history)
    for name in (FlowHarness.CKPT, FlowHarness.BEST, FlowHarness.META):
        assert os.path.exists(os.path.join(h.workdir, name))
    fresh = _harness(h.workdir)
    epoch, best = fresh.load_checkpoint(best=True)
    assert epoch == 3 and best == result.best_epe
    assert fresh.validate(ds, 5) == pytest.approx(result.best_epe, rel=1e-6)


def test_infer_writes_flo_files_that_reproduce_its_epe(chairs_dir, tmp_path):
    """Batches of 4 over 10 samples (the last one padded), full-res flow
    upsample4(flow2 * 20) saved as %06d.flo."""
    ds = TChairs(chairs_dir)
    h = _harness(str(tmp_path / "run"))
    out = tmp_path / "flows"
    res = h.infer(ds, batch_size=4, save_dir=str(out))
    files = sorted(os.listdir(out))
    assert res["n"] == 10 and files == [f"{i:06d}.flo" for i in range(10)]
    epes = []
    for i, (_, target) in enumerate(ds.batches(1, shuffle=False)):
        flow = read_flo(str(out / files[i]))
        assert flow.shape == (64, 64, 2)
        epes.append(np.sqrt(np.sum((flow - target[0]) ** 2, -1)).mean())
    assert np.mean(epes) == pytest.approx(res["epe"], rel=1e-5)
    assert h.infer(ds, batch_size=4, n_batches=1)["n"] == 4


def test_datasets_batch_like_jax(chairs_dir, tmp_path):
    """The copied FlyingChairs batches equal vec_vad_tpu's byte for byte,
    with a seeded random crop and with the /64 render-size center crop;
    the .flo IO copy reads and writes the same files."""
    for kw in (dict(crop_size=(48, 40), aug_seed=5), {}):
        t, j = TChairs(chairs_dir, **kw), JChairs(chairs_dir, **kw)
        assert t.sample_size == j.sample_size
        for (tp, tf), (jp, jf) in zip(t.batches(4, shuffle=True, seed=3),
                                      j.batches(4, shuffle=True, seed=3)):
            assert tp.tobytes() == jp.tobytes() and tf.tobytes() == jf.tobytes()
    flow = np.random.default_rng(4).normal(size=(5, 7, 2)).astype(np.float32)
    write_flo(str(tmp_path / "t.flo"), flow)
    jflowviz.write_flo(str(tmp_path / "j.flo"), flow)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(jflowviz.read_flo(str(tmp_path / "t.flo")),
                                  read_flo(str(tmp_path / "t.flo")))


def test_cli_flow_train_and_infer_on_the_cpu(chairs_dir, tmp_path):
    """python -m vec_vad_torch flow-train --net FlowNetC --device cpu,
    one epoch over the fixture; then flow-infer from its workdir."""
    wd = tmp_path / "wd"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}

    def run(*args):
        r = subprocess.run(
            [sys.executable, "-m", "vec_vad_torch", *args], cwd=str(tmp_path),
            capture_output=True, text=True, timeout=300, env=env,
        )
        assert r.returncode == 0, r.stderr
        return r.stdout

    out = run("flow-train", "--data-root", chairs_dir, "--workdir", str(wd),
              "--net", "FlowNetC", "--loss", "multiscale", "--norm", "L1",
              "--epochs", "1", "--batch-size", "5", "--device", "cpu")
    assert "epoch 1: loss" in out and "best validation EPE" in out
    assert (wd / FlowHarness.CKPT).exists() and (wd / FlowHarness.BEST).exists()
    out = run("flow-infer", "--data-root", chairs_dir, "--workdir", str(wd),
              "--net", "FlowNetC", "--batch-size", "5", "--n-batches", "1",
              "--save-flow", "--device", "cpu")
    assert "loaded" in out and "inference EPE over 5 samples" in out
    assert len(os.listdir(wd / "inference")) == 5


@pytest.mark.parametrize("net,loss", [("FlowNet2", "multiscale"),
                                      ("FlowNet2CSS", "multiscale"),
                                      ("FlowNetC", "L1"), ("FlowNetS", "L2")])
def test_cli_refuses_like_jax(net, loss):
    """Composite + pyramid loss and component + single-scale loss are
    refused with vec_vad_tpu's messages."""
    ns = argparse.Namespace(net=net, loss=loss, norm="L1", device="cpu")
    msgs = []
    for cmd in (jcli.cmd_flow_train, tcli.cmd_flow_train):
        with pytest.raises(SystemExit) as e:
            cmd(ns)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and net in msgs[0]


def test_cli_flow_infer_without_weights_refuses(chairs_dir, tmp_path):
    with pytest.raises(SystemExit, match="flow-infer needs weights"):
        tcli.main(["flow-infer", "--data-root", chairs_dir, "--net",
                   "FlowNetC", "--out", str(tmp_path), "--device", "cpu"])
