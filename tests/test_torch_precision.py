"""The port's f32 entry points run their nets with TF32 off.

cuDNN's TF32 (torch's default for convolutions) keeps about three decimal
digits, which moves FlowNet2's flow past the 1e-3 bound that holds the card
to the f32 computation. So `run_calc_flow`, `FlowStreamingScorer.push`,
`FlowTrainer.step`, and on the main path `run_train`, `run_test` and
`infer_frame_scores_resident`, turn both TF32 flags off for the duration of
the call (`vec_vad_torch.device.full_f32`) and give the caller's values
back after.
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


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


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


def _main_path_workspace(base, lengths=(6, 6)):
    """Two seeded 6-frame videos a split as uint8 .npy frames, their .bmp
    label masks and bbox fixtures, in the UCSD layout under DATASET."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    root = os.path.join(base, "raw_datasets", DATASET)
    for split in ("Train", "Test"):
        boxes = []
        for v, n in enumerate(lengths):
            d = os.path.join(root, split, f"{split}{v + 1:03d}")
            os.makedirs(d)
            if split == "Test":
                os.makedirs(d + "_gt")
            for t in range(n):
                np.save(os.path.join(d, f"{t:03d}.npy"),
                        rng.integers(0, 256, HW + (3,), dtype=np.uint8))
                boxes.append(np.array([[2.0 + t, 3.0, 18.0 + t, 20.0],
                                       [10.0, 1.0, 30.0, 15.0 + v]], np.float32))
                if split == "Test":
                    cv2.imwrite(os.path.join(d + "_gt", f"{t:03d}.bmp"),
                                np.full(HW, 255 * (t % 2), np.uint8))
        fixture = np.empty(len(boxes), dtype=object)
        fixture[:] = boxes
        np.save(os.path.join(root, f"bboxes_{split.lower()}_obj_det_with_motion.npy"),
                fixture, allow_pickle=True)


def test_main_path_entry_points_turn_tf32_off(tmp_path, monkeypatch, tf32_on):
    """run_train, run_test and infer_frame_scores_resident: the STC matmuls
    and every completion-net forward see both TF32 flags False; the
    caller's flags come back after each."""
    from vec_vad_torch import pipeline as t_pipe
    from vec_vad_torch.infer import infer_frame_scores_resident
    from vec_vad_torch.ops.stc import pad_boxes

    spec = dataclasses.replace(t_cfg.DATASETS["UCSDped2"], name=DATASET,
                               frame_h=HW[0], frame_w=HW[1], file_ext=".npy")
    monkeypatch.setitem(t_cfg.DATASETS, DATASET, spec)
    _main_path_workspace(str(tmp_path))
    cfg = PipelineConfig(
        dataset_name=DATASET, fore=ForegroundConfig(patch_size=16),
        model=CompletionConfig(nf=4, epochs=1, batch_size=4, context_of_num=0,
                               use_flow=False))
    seen = []
    stc = t_pipe.extract_stc
    monkeypatch.setattr(t_pipe, "extract_stc",
                        lambda *a, **k: seen.append(("stc",) + _flags()) or stc(*a, **k))
    make = t_pipe.make_trainer

    def hooked_trainer(cfg, device):
        trainer = make(cfg, device)
        trainer.net.register_forward_hook(
            lambda mod, inp, out: seen.append(("net",) + _flags()))
        return trainer

    monkeypatch.setattr(t_runner, "make_trainer", hooked_trainer)
    model, _ = t_runner.run_train(cfg, str(tmp_path), device="cpu")
    assert _flags() == (True, True)
    res = t_runner.run_test(cfg, str(tmp_path), device="cpu")
    assert _flags() == (True, True) and np.isfinite(res["frame_scores"]).all()
    kinds = {k for k, *_ in seen}
    assert kinds == {"stc", "net"} and {tuple(f) for _, *f in seen} == {(False, False)}

    seen.clear()
    net = make_completion_net(cfg.model, device="cpu")
    net.register_forward_hook(lambda mod, inp, out: seen.append(("net",) + _flags()))
    frames = np.stack([np.load(os.path.join(tmp_path, "raw_datasets", DATASET, "Test",
                                            "Test001", f"{t:03d}.npy")) for t in range(6)])
    boxes = [np.array([[2.0, 3.0, 18.0, 20.0]], np.float32)] * 6
    boxes_pad, valid = pad_boxes(boxes, 8)
    windows = np.maximum(np.arange(6)[:, None] + np.arange(-4, 1)[None], 0)
    blk = model.blocks[(0, 0, 0)]
    out = infer_frame_scores_resident(cfg, blk.state_dict, blk.raw_stats + (0.0, 1.0),
                                      frames, windows, boxes_pad, valid, net=net,
                                      device="cpu")
    assert np.isfinite(out).all() and _flags() == (True, True)
    assert {k for k, *_ in seen} == {"stc", "net"}
    assert {tuple(f) for _, *f in seen} == {(False, False)}
