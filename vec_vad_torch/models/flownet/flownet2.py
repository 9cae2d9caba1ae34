"""FlowNet2 composite in PyTorch (vec_vad_tpu/models/flownet/flownet2.py).

Graph parity with FlowNet2_src/models/flownet2.py:10-365:
  * joint per-channel mean subtraction over BOTH frames, /255
    (flownet2.py:66-72)
  * FlowNetC -> x20 -> bilinear x4 -> warp img1 -> brightness-error channel
    norm -> 14-ch concat -> FlowNetS1 -> same refinement -> FlowNetS2
  * parallel FlowNetSD branch; FlowNetS2's flow upsampled NEAREST,
    FlowNetSD's flow divided by div_flow then NEAREST (flownet2.py:105,122)
  * FlowNetFusion merges an 11-channel stack -> final full-res flow

Input (B, 2, H, W, 3) frame-major NHWC; output (B, H, W, 2). The other
composites (FlowNet2C/S/SD/CS/CSS) are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vec_vad_torch.device import resolve_device
from vec_vad_torch.models.flownet.nets import (
    FlowNetC,
    FlowNetFusion,
    FlowNetS,
    FlowNetSD,
    init_flownet_,
)
from vec_vad_torch.models.flownet.ops import (
    channel_norm,
    upsample_bilinear,
    upsample_nearest,
    warp_bilinear,
)


def _normalize(inputs: torch.Tensor, rgb_max: float) -> torch.Tensor:
    """(B, 2, H, W, 3) -> mean-subtracted, scaled, channel-concat
    (B, H, W, 6)."""
    mean = torch.mean(inputs, dim=(1, 2, 3), keepdim=True)
    x = (inputs - mean) / rgb_max
    return torch.cat([x[:, 0], x[:, 1]], dim=-1)


class FlowNet2(nn.Module):
    def __init__(self, rgb_max: float = 255.0, div_flow: float = 20.0,
                 align_corners: bool = True, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.rgb_max = rgb_max
        self.div_flow = div_flow
        self.align_corners = align_corners
        self.flownetc = FlowNetC(dev)
        self.flownets_1 = FlowNetS(12, dev)
        self.flownets_2 = FlowNetS(12, dev)
        self.flownets_d = FlowNetSD(dev)
        self.flownetfusion = FlowNetFusion(dev)
        # convolution weights channels_last, like the NHWC activations
        self.to(memory_format=torch.channels_last)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = _normalize(inputs, self.rgb_max)
        img0, img1 = x[..., :3], x[..., 3:]
        ac, df = self.align_corners, self.div_flow

        # FlowNetC stage
        c_flow = upsample_bilinear(self.flownetc(x)[0] * df, 4, ac)
        warped1 = warp_bilinear(img1, c_flow)
        norm_diff = channel_norm(img0 - warped1)
        concat1 = torch.cat([x, warped1, c_flow / df, norm_diff], dim=-1)

        # FlowNetS1 stage
        s1_flow = upsample_bilinear(self.flownets_1(concat1)[0] * df, 4, ac)
        warped1 = warp_bilinear(img1, s1_flow)
        norm_diff = channel_norm(img0 - warped1)
        concat2 = torch.cat([x, warped1, s1_flow / df, norm_diff], dim=-1)

        # FlowNetS2 stage (nearest upsample, flownet2.py:105)
        s2_flow = upsample_nearest(self.flownets_2(concat2)[0] * df, 4)
        norm_s2 = channel_norm(s2_flow)
        diff_s2_img1 = channel_norm(img0 - warp_bilinear(img1, s2_flow))

        # FlowNetSD branch (flow DIVIDED by div_flow, flownet2.py:122)
        sd_flow = upsample_nearest(self.flownets_d(x)[0] / df, 4)
        norm_sd = channel_norm(sd_flow)
        diff_sd_img1 = channel_norm(img0 - warp_bilinear(img1, sd_flow))

        concat3 = torch.cat(
            [img0, sd_flow, s2_flow, norm_sd, norm_s2, diff_sd_img1,
             diff_s2_img1],
            dim=-1,
        )  # 3+2+2+1+1+1+1 = 11 channels
        return self.flownetfusion(concat3)


def make_flownet2(seed: int = 0, device="cuda", **kw) -> FlowNet2:
    """A FlowNet2 with the reference's random init drawn from a numpy
    seed, in eval mode on `device`."""
    return init_flownet_(FlowNet2(device=device, **kw), seed).eval()
