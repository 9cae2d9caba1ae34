"""The plain reference against the port at a tiny size on the CPU: the
same weights and inputs through both, float32 on both sides."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vadbench import traffic
from vadbench.reference import ensemble as ref_ensemble
from vadbench.reference import flownet2 as ref_flownet2
from vadbench.reference import scoring as ref_scoring

MODEL = {"nf": 4, "context_frame_num": 4, "context_of_num": 0, "use_flow": True,
         "learning_rate": 1e-3, "adam_eps": 1e-7, "epochs": 1, "batch_size": 16}


def _completion_net(use_flow):
    from vec_vad_torch.config import CompletionConfig
    from vec_vad_torch.models.completion import make_completion_net

    cfg = CompletionConfig(nf=4, context_frame_num=4, context_of_num=0, use_flow=use_flow,
                           epochs=1, batch_size=16)
    return cfg, make_completion_net(cfg, "cpu")


@pytest.fixture(scope="module")
def flow_weights():
    return traffic.weights(ref_flownet2.spec(), 5, "cpu", stream=6)


def test_flownet2_against_the_port(flow_weights):
    from vec_vad_torch.flow.driver import _flow_batch
    from vec_vad_torch.models.flownet.flownet2 import FlowNet2

    net = FlowNet2(device="cpu").eval()
    net.load_state_dict(flow_weights)
    frames = traffic.frames(3, 2, 2, (40, 56), 3, "cpu")  # (2 cams, 2 frames, ...)
    with torch.no_grad():
        got = _flow_batch(net, frames[:, 0], frames[:, 1], (64, 64), torch.float32)
        want = ref_flownet2.frame_flow(flow_weights, frames[:, 0], frames[:, 1], (64, 64))
    scale = want.abs().max()
    assert scale > 0
    assert float((got - want).abs().max() / scale) < 1e-5


@pytest.mark.parametrize("use_flow", [True, False])
def test_ensemble_scores_against_the_port(use_flow):
    model = dict(MODEL, use_flow=use_flow)
    _, net = _completion_net(use_flow)
    sd = traffic.weights(ref_ensemble.spec(model), 3, "cpu")
    net.load_state_dict(sd)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((6, 16, 16, 15), generator=g)
    x_of = torch.randn((6, 16, 16, 2), generator=g)
    with torch.no_grad():
        out = net(x, x_of)
        raw, flow = ref_ensemble.cube_scores(sd, model, x, x_of)
    got = (out.raw_out - out.raw_tgt).square().sum(dim=(0, 2, 3, 4))
    assert float((got - raw).abs().max() / raw.abs().max()) < 1e-6
    if use_flow:
        got_of = (out.of_out - out.of_tgt).square().sum(dim=(0, 2, 3, 4))
        assert float((got_of - flow).abs().max() / flow.abs().max()) < 1e-6


def test_cubes_against_the_ports_extraction():
    from vec_vad_torch.ops.stc import cube_to_input, extract_stc

    video = traffic.frames(7, 5, 1, (48, 64), 3, "cpu")[0]  # (5, 48, 64, 3)
    flow = 4.0 * torch.randn((1, 48, 64, 2), generator=torch.Generator().manual_seed(7))
    boxes = traffic.boxes(np.array([6]), (48, 64), (4, 30), traffic.host_rng(7))[0]
    x, x_of, mag = ref_scoring.frame_cubes(video, torch.from_numpy(boxes), 16, flow)
    b = torch.from_numpy(boxes)
    got = cube_to_input(extract_stc(video, b, 16, quantize=True), scale=False) / 255.0
    assert float((got - x).abs().max()) <= 1.0 / 255.0 + 1e-6
    assert float((got - x).abs().mean()) < 1e-4
    fc = extract_stc(flow, b, 16)
    assert torch.allclose(cube_to_input(fc, scale=False), x_of, atol=1e-5)
    from vec_vad_torch.ops.stc import flow_magnitude

    assert torch.allclose(flow_magnitude(fc), mag, rtol=1e-5)


def test_training_steps_against_the_port():
    from vec_vad_torch.train.trainer import BlockTrainer

    cfg, _ = _completion_net(False)
    model = dict(MODEL, use_flow=False)
    sd0 = traffic.weights(ref_ensemble.spec(model, train=True), 1, "cpu", stream=100)
    cubes = traffic.train_cubes(1, 48, 16, 5, "cpu")
    trainer = BlockTrainer(cfg, 16, device="cpu")
    block = trainer.fit_block(cubes, None, seed=9, init_state=sd0)
    order = np.random.default_rng(9).permutation(48)
    batches = [(cubes[torch.as_tensor(order[s * 16:(s + 1) * 16])].float() / 255.0, None,
                torch.ones(16)) for s in range(3)]
    losses, _, _ = ref_ensemble.train_steps(sd0, model, batches)
    np.testing.assert_allclose(block.losses[:3], losses, rtol=1e-5)
