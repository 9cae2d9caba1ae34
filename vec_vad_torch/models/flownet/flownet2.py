"""FlowNet2 composite and its released variants in PyTorch
(vec_vad_tpu/models/flownet/flownet2.py).

Graph parity with FlowNet2_src/models/flownet2.py:10-365:
  * joint per-channel mean subtraction over BOTH frames, /255
    (flownet2.py:66-72)
  * FlowNetC -> x20 -> bilinear x4 -> warp img1 -> brightness-error channel
    norm -> 14-ch concat -> FlowNetS1 -> same refinement -> FlowNetS2
  * parallel FlowNetSD branch; FlowNetS2's flow upsampled NEAREST,
    FlowNetSD's flow divided by div_flow then NEAREST (flownet2.py:105,122)
  * FlowNetFusion merges an 11-channel stack -> final full-res flow

Input (B, 2, H, W, 3) frame-major NHWC; output (B, H, W, 2). The single-net
wrappers FlowNet2C/2S/2SD return their net's pyramid when `train` and the
full-res flow upsample_bilinear(flow2 * div_flow, 4) otherwise; the
composites FlowNet2/2CS/2CSS return the full-res flow under both flags.
`with_bn` builds every component net with BatchNorm, whose batch
statistics `train` selects (models/flownet/nets.py).
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


class _Composite(nn.Module):
    """Shared settings of the FlowNet2 family; `nets` maps submodule
    names to constructors taking (with_bn, device). Convolution weights
    are channels_last, like the NHWC activations."""

    def __init__(self, nets, with_bn: bool = False, rgb_max: float = 255.0,
                 div_flow: float = 20.0, align_corners: bool = True,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.with_bn = with_bn
        self.rgb_max = rgb_max
        self.div_flow = div_flow
        self.align_corners = align_corners
        for name, make in nets.items():
            setattr(self, name, make(with_bn, dev))
        self.to(memory_format=torch.channels_last)

    def _refine(self, x, net_input, net, train):
        """The next stage's 14-channel input after `net`: the normalized
        pair x, img1 warped by net's flow upsampled to full resolution, that
        flow, and the brightness error."""
        img0, img1 = x[..., :3], x[..., 3:]
        df = self.div_flow
        flow = upsample_bilinear(net(net_input, train)[0] * df, 4,
                                 self.align_corners)
        warped1 = warp_bilinear(img1, flow)
        return torch.cat(
            [x, warped1, flow / df, channel_norm(img0 - warped1)], dim=-1
        )

    def _wrapper(self, net, inputs, train):
        flows = net(_normalize(inputs, self.rgb_max), train)
        if train:
            return flows
        return upsample_bilinear(flows[0] * self.div_flow, 4, self.align_corners)


class FlowNet2(_Composite):
    def __init__(self, **kw):
        super().__init__({
            "flownetc": FlowNetC,
            "flownets_1": lambda bn, d: FlowNetS(12, bn, d),
            "flownets_2": lambda bn, d: FlowNetS(12, bn, d),
            "flownets_d": FlowNetSD,
            "flownetfusion": FlowNetFusion,
        }, **kw)

    def forward(self, inputs: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = _normalize(inputs, self.rgb_max)
        img0, img1 = x[..., :3], x[..., 3:]
        df = self.div_flow

        # FlowNetC and FlowNetS1 stages
        concat1 = self._refine(x, x, self.flownetc, train)
        concat2 = self._refine(x, concat1, self.flownets_1, train)

        # FlowNetS2 stage (nearest upsample, flownet2.py:105)
        s2_flow = upsample_nearest(self.flownets_2(concat2, train)[0] * df, 4)
        norm_s2 = channel_norm(s2_flow)
        diff_s2_img1 = channel_norm(img0 - warp_bilinear(img1, s2_flow))

        # FlowNetSD branch (flow DIVIDED by div_flow, flownet2.py:122)
        sd_flow = upsample_nearest(self.flownets_d(x, train)[0] / df, 4)
        norm_sd = channel_norm(sd_flow)
        diff_sd_img1 = channel_norm(img0 - warp_bilinear(img1, sd_flow))

        concat3 = torch.cat(
            [img0, sd_flow, s2_flow, norm_sd, norm_s2, diff_sd_img1,
             diff_s2_img1],
            dim=-1,
        )  # 3+2+2+1+1+1+1 = 11 channels
        return self.flownetfusion(concat3, train)


class FlowNet2C(_Composite):
    def __init__(self, **kw):
        super().__init__({"flownetc": FlowNetC}, **kw)

    def forward(self, inputs, train: bool = False):
        return self._wrapper(self.flownetc, inputs, train)


class FlowNet2S(_Composite):
    def __init__(self, **kw):
        super().__init__({"flownets": lambda bn, d: FlowNetS(6, bn, d)}, **kw)

    def forward(self, inputs, train: bool = False):
        return self._wrapper(self.flownets, inputs, train)


class FlowNet2SD(_Composite):
    def __init__(self, **kw):
        super().__init__({"flownetsd": FlowNetSD}, **kw)

    def forward(self, inputs, train: bool = False):
        return self._wrapper(self.flownetsd, inputs, train)


class FlowNet2CS(_Composite):
    def __init__(self, **kw):
        super().__init__({
            "flownetc": FlowNetC,
            "flownets_1": lambda bn, d: FlowNetS(12, bn, d),
        }, **kw)

    def forward(self, inputs, train: bool = False):
        x = _normalize(inputs, self.rgb_max)
        concat1 = self._refine(x, x, self.flownetc, train)
        return upsample_bilinear(
            self.flownets_1(concat1, train)[0] * self.div_flow, 4,
            self.align_corners,
        )


class FlowNet2CSS(_Composite):
    def __init__(self, **kw):
        super().__init__({
            "flownetc": FlowNetC,
            "flownets_1": lambda bn, d: FlowNetS(12, bn, d),
            "flownets_2": lambda bn, d: FlowNetS(12, bn, d),
        }, **kw)

    def forward(self, inputs, train: bool = False):
        x = _normalize(inputs, self.rgb_max)
        concat1 = self._refine(x, x, self.flownetc, train)
        concat2 = self._refine(x, concat1, self.flownets_1, train)
        # final upsample is NEAREST in the reference (flownet2.py:310,363)
        return upsample_nearest(
            self.flownets_2(concat2, train)[0] * self.div_flow, 4
        )


def make_flownet2(seed: int = 0, device="cuda", **kw) -> FlowNet2:
    """A FlowNet2 with the reference's random init drawn from a numpy
    seed, in eval mode on `device`."""
    return init_flownet_(FlowNet2(device=device, **kw), seed).eval()
