"""The yardstick's counts: a hand count of one UNet member, the port's own
hook count of a tiny ensemble (read here only, never by the harness), a
count of every convolution the reference FlowNet2 runs, and K1's bound
at the served shape."""

from __future__ import annotations

import pytest
import torch

from vadbench import counts
from vadbench.reference import flownet2 as ref_flownet2


def test_unet_member_matches_a_hand_count():
    # nf=32, a raw member (12 in, 3 out) on a 32 x 32 cube; 2 * I * O * 9 * H * W
    def c3(i, o, s):
        return 2 * i * o * 9 * s * s

    hand = (c3(12, 32, 32) + c3(32, 32, 32) + c3(32, 64, 16) + c3(64, 64, 16)
            + c3(64, 128, 8) + c3(128, 128, 8) + c3(128, 256, 4) + c3(256, 256, 4)
            + 2 * 256 * 128 * 9 * 4 * 4 + c3(256, 128, 8) + c3(128, 128, 8)
            + 2 * 128 * 64 * 9 * 8 * 8 + c3(128, 64, 16) + c3(64, 64, 16)
            + 2 * 64 * 32 * 9 * 16 * 16 + c3(64, 32, 32) + c3(32, 32, 32)
            + 2 * 32 * 3 * 32 * 32)
    assert counts.unet_member_flops(12, 3, 32, 32) == hand
    model = {"nf": 32, "context_frame_num": 4, "context_of_num": 0, "use_flow": True}
    assert counts.cube_fwd_flops(model, 32) == 5 * hand + counts.unet_member_flops(12, 2, 32, 32)


@pytest.mark.parametrize("use_flow", [True, False])
def test_ensemble_matches_the_ports_hook_count_on_a_tiny_net(use_flow):
    from vec_vad_torch.config import CompletionConfig
    from vec_vad_torch.models.completion import make_completion_net
    from vec_vad_torch.runtime.layer_profile import completion_fwd_flops

    cfg = CompletionConfig(nf=4, context_frame_num=4, context_of_num=0, use_flow=use_flow)
    net = make_completion_net(cfg, "cpu")
    model = {"nf": 4, "context_frame_num": 4, "context_of_num": 0, "use_flow": use_flow}
    assert counts.cube_fwd_flops(model, 16) == completion_fwd_flops(net, 16)


def test_flownet2_matches_every_convolution_the_reference_runs(monkeypatch):
    """At 64 x 128 (conv6 at 1 x 2), every conv and transposed conv of
    the reference FlowNet2 counted as it runs, plus the cost volume."""
    total = [0.0]
    real_conv, real_convt = ref_flownet2.conv, ref_flownet2.convt

    def conv(x, w, b=None, stride=1, pad=None, lowp=False):
        y = real_conv(x, w, b, stride, pad, lowp)
        total[0] += 2.0 * w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3] * y.shape[2] * y.shape[3]
        return y

    def convt(x, w, b=None, stride=2, pad=1, outpad=0, lowp=False):
        total[0] += 2.0 * w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3] * x.shape[2] * x.shape[3]
        return real_convt(x, w, b, stride, pad, outpad, lowp)

    monkeypatch.setattr(ref_flownet2, "conv", conv)
    monkeypatch.setattr(ref_flownet2, "convt", convt)
    sd = {name: torch.zeros(shape) for name, shape, _ in ref_flownet2.spec()}
    with torch.no_grad():
        ref_flownet2.flownet2(sd, torch.zeros(1, 2, 3, 64, 128))
    corr = counts.correlation_flops(counts.flownet_c_corr_shape(1, 64, 128))
    assert total[0] + corr == counts.flownet2_pair_flops(64, 128)
    # at the served protocol: about 199 GFLOP a pair
    assert 1.9e11 < counts.flownet2_pair_flops(384, 512) < 2.1e11


def test_k1_bound_at_the_served_shape():
    t, kind = counts.correlation_bound_s(counts.flownet_c_corr_shape(8))
    assert kind == "operations"
    assert t == pytest.approx(5.4147e-5, rel=1e-4)  # 0.054 ms at (8, 48, 64, 256)


def test_work_counts_only_valid_cubes_and_pairs():
    model = {"nf": 32, "context_frame_num": 4, "context_of_num": 0, "use_flow": True}
    fwd = counts.cube_fwd_flops(model, 32)
    w = counts.work_flops({"valid_cubes": 10, "flow_pairs": 2}, model, 32)
    assert w == 10 * fwd + 2 * counts.flownet2_pair_flops()
    t = counts.work_flops({"train_cubes": 4, "score_cubes": 1}, model, 32)
    assert t == 13 * fwd
