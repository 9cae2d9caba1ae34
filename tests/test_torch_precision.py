"""The port's f32 entry points run their flow nets with TF32 off.

cuDNN's TF32 (torch's default for convolutions) keeps about three decimal
digits, which moves FlowNet2's flow past the 1e-3 bound that holds the card
to the f32 computation. So `run_calc_flow`, `FlowStreamingScorer.push` and
`FlowTrainer.step` turn both TF32 flags off for the duration of the call
(`vec_vad_torch.device.full_f32`) and give the caller's values back after.
A forward hook on the flow net reads the flags where the net runs; the
flags are plain settings, so this holds on the CPU as on the card. The bf16
routes leave them as they are."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vec_vad_torch import config as t_cfg
from vec_vad_torch import runner as t_runner
from vec_vad_torch.config import CompletionConfig, ForegroundConfig, PipelineConfig
from vec_vad_torch.flow.trainer import FlowTrainer
from vec_vad_torch.models.completion import init_completion_state, make_completion_net
from vec_vad_torch.pipeline import TrainedBlock, VadModel
from vec_vad_torch.serve import FlowStreamingScorer

HW = (24, 32)  # tiny frames
DATASET = "tf32probe"


class ProbeFlow(torch.nn.Module):
    """A one-convolution flow net with FlowNet2's contracts: (B, 2, h, w, 3)
    frame pairs, or the trainer's channel-stacked (B, h, w, 6) pairs, to
    (B, h, w, 2) flow. A forward hook records the TF32 flags each call
    sees."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(6, 2, 3, padding=1)
        self.seen = []
        self.register_forward_hook(lambda mod, inp, out: self.seen.append(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))

    def forward(self, x, train: bool = False):
        if x.dim() == 5:
            x = torch.cat([x[:, 0], x[:, 1]], dim=-1)
        return self.conv((x / 255.0).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.fixture
def tf32_on():
    """Both TF32 flags True (as a caller may leave them) for the test;
    torch's values restored after."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("flow_dtype", ["float32", "bfloat16"])
def test_run_calc_flow_turns_tf32_off_in_f32(tmp_path, monkeypatch, tf32_on, flow_dtype):
    spec = dataclasses.replace(t_cfg.DATASETS["UCSDped2"], name=DATASET,
                               frame_h=HW[0], frame_w=HW[1], file_ext=".npy")
    monkeypatch.setitem(t_cfg.DATASETS, DATASET, spec)
    rng = np.random.default_rng(0)
    d = tmp_path / "raw_datasets" / DATASET / "Train" / "Train001"
    os.makedirs(d)
    for t in range(3):
        np.save(d / f"{t:03d}.npy", rng.integers(0, 256, HW + (3,), dtype=np.uint8))
    net = ProbeFlow()
    monkeypatch.setattr(t_runner, "make_flownet2", lambda seed, device: net)
    t_runner.run_calc_flow(PipelineConfig(dataset_name=DATASET), str(tmp_path),
                           splits=("train",), flow_dtype=flow_dtype, device="cpu")
    want = (False, False) if flow_dtype == "float32" else (True, True)
    assert net.seen and set(net.seen) == {want}
    assert _flags() == (True, True)


def test_live_push_turns_tf32_off(tf32_on):
    cfg = PipelineConfig(
        dataset_name="UCSDped2",
        fore=ForegroundConfig(patch_size=16, max_boxes_per_frame=8),
        model=CompletionConfig(nf=4, context_of_num=0, use_flow=True),
    )
    sd = init_completion_state(make_completion_net(cfg.model, device="cpu"), 1)
    rng = np.random.default_rng(1)
    block = TrainedBlock(sd, rng.normal(100.0, 10.0, 16).astype(np.float32),
                         rng.normal(10.0, 1.0, 16).astype(np.float32))
    net = ProbeFlow()
    scorer = FlowStreamingScorer.from_model(
        VadModel(cfg=cfg, blocks={(0, 0, 0): block}), flow_net=net,
        flow_model_hw=(16, 24), device="cpu")
    box = np.array([[4.0, 4.0, 28.0, 20.0]], np.float32)
    scorer.start_video()
    scores = [scorer.push(rng.integers(0, 256, HW + (3,), dtype=np.uint8), box)
              for _ in range(3)]
    assert len(net.seen) == 2 and set(net.seen) == {(False, False)}
    assert _flags() == (True, True)
    assert scores[1] is None and np.isfinite([scores[0], scores[2]]).all()


def test_trainer_step_turns_tf32_off(tf32_on):
    net = ProbeFlow()
    trainer = FlowTrainer(net, loss="single", device="cpu")
    rng = np.random.default_rng(2)
    m = trainer.step(rng.uniform(0, 255, (2,) + HW + (6,)),
                     rng.normal(0, 1, (2,) + HW + (2,)))
    assert net.seen == [(False, False)]
    assert _flags() == (True, True)
    assert np.isfinite(float(m["loss"]))
