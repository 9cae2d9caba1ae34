"""FlowNet2 (Ilg et al., CVPR 2017; FlowNet2_src/models/flownet2.py and
components/) without BatchNorm, in plain PyTorch, NCHW, with FlowNetC's
cost volume as an einsum over shifted windows.

Weights are read from a state dict whose names follow the released
checkpoint's modules (`flownetc.conv1.conv.weight`, `flownetc.deconv5.
conv.weight`, `flownetc.predict_flow6.weight`, ...); `spec` lists them
with the reference's init (xavier-uniform weights, U(0, 1) biases).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from vadbench.reference.ops import conv, convt, leaky, resize

MAX_DISP, STRIDE = 20, 2
DIV_FLOW, RGB_MAX = 20.0, 255.0

_S_TAIL = [("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
           ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
           ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1)]
_C_HEAD = [("conv1", 3, 64, 7, 2), ("conv2", 64, 128, 5, 2), ("conv3", 128, 256, 5, 2)]
_SD = [("conv0", 6, 64, 3, 1), ("conv1", 64, 64, 3, 2), ("conv1_1", 64, 128, 3, 1),
       ("conv2", 128, 128, 3, 2), ("conv2_1", 128, 128, 3, 1),
       ("conv3", 128, 256, 3, 2), ("conv3_1", 256, 256, 3, 1)] + _S_TAIL
_FUSION = [("conv0", 11, 64, 3, 1), ("conv1", 64, 64, 3, 2), ("conv1_1", 64, 128, 3, 1),
           ("conv2", 128, 128, 3, 2), ("conv2_1", 128, 128, 3, 1)]
_PRED_IN = (1024, 512 + 512 + 2, 512 + 256 + 2, 256 + 128 + 2, 128 + 64 + 2)
_INTER = ((5, 512 + 512 + 2, 512), (4, 512 + 256 + 2, 256), (3, 256 + 128 + 2, 128),
          (2, 128 + 64 + 2, 64))


def _s_layers(cin: int):
    return [("conv1", cin, 64, 7, 2), ("conv2", 64, 128, 5, 2),
            ("conv3", 128, 256, 5, 2), ("conv3_1", 256, 256, 3, 1)] + _S_TAIL


def spec() -> List[Tuple[str, tuple, str]]:
    out = []

    def w(name, shape):
        a, b, k, _ = shape
        out.append((f"{name}.weight", shape, f"xavier:{math.sqrt(6.0 / (k * k * (a + b)))}"))

    def conv_leaf(name, cin, cout, k, bias=True):
        w(name, (cout, cin, k, k))
        if bias:
            out.append((f"{name}.bias", (cout,), "unit"))

    def convt_leaf(name, cin, cout, bias=True):
        w(name, (cin, cout, 4, 4))
        if bias:
            out.append((f"{name}.bias", (cout,), "unit"))

    def decoder(p, up_bias, inter):
        convt_leaf(f"{p}.deconv5.conv", 1024, 512)
        convt_leaf(f"{p}.deconv4.conv", 1026, 256)
        convt_leaf(f"{p}.deconv3.conv", 770, 128)
        convt_leaf(f"{p}.deconv2.conv", 386, 64)
        if inter:
            for i, cin, cout in _INTER:
                conv_leaf(f"{p}.inter_conv{i}.conv", cin, cout, 3)
            pred_in = (1024, 512, 256, 128, 64)
        else:
            pred_in = _PRED_IN
        for i, cin in zip((6, 5, 4, 3, 2), pred_in):
            conv_leaf(f"{p}.predict_flow{i}", cin, 2, 3)
        for i in (6, 5, 4, 3):
            convt_leaf(f"{p}.upsampled_flow{i}_to_{i - 1}", 2, 2, up_bias)

    for name, cin, cout, k, _ in _C_HEAD:
        conv_leaf(f"flownetc.{name}.conv", cin, cout, k)
    conv_leaf("flownetc.conv_redir.conv", 256, 32, 1)
    conv_leaf("flownetc.conv3_1.conv", 32 + 441, 256, 3)
    for name, cin, cout, k, _ in _S_TAIL:
        conv_leaf(f"flownetc.{name}.conv", cin, cout, k)
    decoder("flownetc", True, False)
    for p in ("flownets_1", "flownets_2"):
        for name, cin, cout, k, _ in _s_layers(12):
            conv_leaf(f"{p}.{name}.conv", cin, cout, k)
        decoder(p, False, False)
    for name, cin, cout, k, _ in _SD:
        conv_leaf(f"flownets_d.{name}.conv", cin, cout, k)
    decoder("flownets_d", True, True)
    for name, cin, cout, k, _ in _FUSION:
        conv_leaf(f"flownetfusion.{name}.conv", cin, cout, k)
    convt_leaf("flownetfusion.deconv1.conv", 128, 32)
    convt_leaf("flownetfusion.deconv0.conv", 162, 16)
    conv_leaf("flownetfusion.inter_conv1.conv", 162, 32, 3)
    conv_leaf("flownetfusion.inter_conv0.conv", 82, 16, 3)
    for i, cin in ((2, 128), (1, 32), (0, 16)):
        conv_leaf(f"flownetfusion.predict_flow{i}", cin, 2, 3)
    convt_leaf("flownetfusion.upsampled_flow2_to_1", 2, 2)
    convt_leaf("flownetfusion.upsampled_flow1_to_0", 2, 2)
    return out


class _Net:
    def __init__(self, sd: Dict[str, torch.Tensor], lowp: bool):
        self.sd, self.lowp = sd, lowp

    def conv(self, name, x, stride=1, relu=True):
        y = conv(x, self.sd[f"{name}.weight"], self.sd.get(f"{name}.bias"),
                 stride, lowp=self.lowp)
        return leaky(y) if relu else y

    def convt(self, name, x, relu=False):
        y = convt(x, self.sd[f"{name}.weight"], self.sd.get(f"{name}.bias"), 2, 1,
                  lowp=self.lowp)
        return leaky(y) if relu else y

    def chain(self, p, layers, x):
        for name, _, _, _, stride in layers:
            x = self.conv(f"{p}.{name}.conv", x, stride)
        return x

    def decode(self, p, c6, c5, c4, c3, c2, inter):
        def head(i, x):
            if inter:
                x = self.conv(f"{p}.inter_conv{i}.conv", x, relu=False)
            return self.conv(f"{p}.predict_flow{i}", x, relu=False)

        flow = self.conv(f"{p}.predict_flow6", c6, relu=False)
        feat = c6
        for i, skip in zip((5, 4, 3, 2), (c5, c4, c3, c2)):
            feat = torch.cat([skip, self.convt(f"{p}.deconv{i}.conv", feat, True),
                              self.convt(f"{p}.upsampled_flow{i + 1}_to_{i}", flow)], 1)
            flow = head(i, feat)
        return flow  # flow2

    def flownet_c(self, x):
        p = "flownetc"
        c2a = self.chain(p, _C_HEAD[:2], x[:, :3])
        fa = self.chain(p, _C_HEAD[2:], c2a)
        fb = self.chain(p, _C_HEAD, x[:, 3:])
        corr = leaky(cost_volume(fa, fb, self.lowp))
        redir = self.conv(f"{p}.conv_redir.conv", fa)
        c3 = self.conv(f"{p}.conv3_1.conv", torch.cat([redir, corr], 1))
        c4 = self.chain(p, _S_TAIL[:2], c3)
        c5 = self.chain(p, _S_TAIL[2:4], c4)
        c6 = self.chain(p, _S_TAIL[4:], c5)
        return self.decode(p, c6, c5, c4, c3, c2a, False)

    def flownet_s(self, p, x):
        layers = _s_layers(x.shape[1])
        c2 = self.chain(p, layers[:2], x)
        c3 = self.chain(p, layers[2:4], c2)
        c4 = self.chain(p, layers[4:6], c3)
        c5 = self.chain(p, layers[6:8], c4)
        c6 = self.chain(p, layers[8:], c5)
        return self.decode(p, c6, c5, c4, c3, c2, False)

    def flownet_sd(self, x):
        p = "flownets_d"
        c2 = self.chain(p, _SD[:5], x)
        c3 = self.chain(p, _SD[5:7], c2)
        c4 = self.chain(p, _SD[7:9], c3)
        c5 = self.chain(p, _SD[9:11], c4)
        c6 = self.chain(p, _SD[11:], c5)
        return self.decode(p, c6, c5, c4, c3, c2, True)

    def fusion(self, x):
        p = "flownetfusion"
        c0 = self.chain(p, _FUSION[:1], x)
        c1 = self.chain(p, _FUSION[1:3], c0)
        c2 = self.chain(p, _FUSION[3:], c1)
        flow2 = self.conv(f"{p}.predict_flow2", c2, relu=False)
        cat1 = torch.cat([c1, self.convt(f"{p}.deconv1.conv", c2, True),
                          self.convt(f"{p}.upsampled_flow2_to_1", flow2)], 1)
        flow1 = self.conv(f"{p}.predict_flow1",
                          self.conv(f"{p}.inter_conv1.conv", cat1, relu=False), relu=False)
        cat0 = torch.cat([c0, self.convt(f"{p}.deconv0.conv", cat1, True),
                          self.convt(f"{p}.upsampled_flow1_to_0", flow1)], 1)
        return self.conv(f"{p}.predict_flow0",
                         self.conv(f"{p}.inter_conv0.conv", cat0, relu=False), relu=False)


def cost_volume(a: torch.Tensor, b: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    """(B, C, H, W) features -> (B, 441, H, W): channel (i * 21 + j) is
    the mean over C of a times b displaced by (dy_i, dx_j), dy and dx in
    -20..20 step 2, b zero outside the frame."""
    from vadbench.reference.ops import tf32

    if lowp:
        a, b = tf32(a), tf32(b)
    B, C, H, W = a.shape
    p = MAX_DISP
    bp = F.pad(b, (p, p, p, p))
    outs = []
    for dy in range(-p, p + 1, STRIDE):
        rows = bp[:, :, p + dy:p + dy + H, :]  # (B, C, H, W + 2p)
        win = rows.unfold(3, 2 * p + 1, 1)[..., ::STRIDE]  # (B, C, H, W, 21)
        outs.append(torch.einsum("bchw,bchwd->bdhw", a, win))
    return torch.cat(outs, 1) / C


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img sampled at (x + u, y + v), bilinear: the position clamped into
    the frame, the corners and the blend weights taken from the clamped
    position (Resample2d's CUDA kernel)."""
    B, C, H, W = img.shape
    ys = torch.arange(H, device=img.device, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=img.device, dtype=torch.float32)[None, :]
    xf = (xs + flow[:, 0]).clamp(0, W - 1)
    yf = (ys + flow[:, 1]).clamp(0, H - 1)
    x0, y0 = xf.floor(), yf.floor()
    ax, ay = (xf - x0)[:, None], (yf - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    flat = img.reshape(B, C, H * W)

    def at(yy, xx):
        idx = (yy * W + xx).reshape(B, 1, H * W).expand(B, C, H * W)
        return flat.gather(2, idx).reshape(B, C, H, W)

    return ((1 - ax) * (1 - ay) * at(y0, x0) + ax * (1 - ay) * at(y0, x1)
            + (1 - ax) * ay * at(y1, x0) + ax * ay * at(y1, x1))


def _norm(x):
    return torch.sqrt((x * x).sum(1, keepdim=True))


def flownet2(sd, pairs: torch.Tensor, lowp: bool = False) -> torch.Tensor:
    """(B, 2, 3, H, W) frame pairs in 0..255 -> (B, 2, H, W) flow."""
    net = _Net(sd, lowp)
    mean = pairs.mean(dim=(1, 3, 4), keepdim=True)
    x = (pairs - mean) / RGB_MAX
    img0, img1 = x[:, 0], x[:, 1]
    x = torch.cat([img0, img1], 1)

    def up4(f):
        return F.interpolate(f, scale_factor=4, mode="bilinear", align_corners=True)

    def refine(flow_small):
        flow = up4(flow_small * DIV_FLOW)
        w1 = _warp(img1, flow)
        return torch.cat([x, w1, flow / DIV_FLOW, _norm(img0 - w1)], 1)

    cat1 = refine(net.flownet_c(x))
    cat2 = refine(net.flownet_s("flownets_1", cat1))
    s2 = F.interpolate(net.flownet_s("flownets_2", cat2) * DIV_FLOW, scale_factor=4,
                       mode="nearest")
    sd_flow = F.interpolate(net.flownet_sd(x) / DIV_FLOW, scale_factor=4, mode="nearest")
    cat3 = torch.cat([img0, sd_flow, s2, _norm(sd_flow), _norm(s2),
                      _norm(img0 - _warp(img1, sd_flow)),
                      _norm(img0 - _warp(img1, s2))], 1)
    return net.fusion(cat3)


def frame_flow(sd, f0: torch.Tensor, f1: torch.Tensor, model_hw,
               lowp: bool = False) -> torch.Tensor:
    """The flow of frame pairs (B, H, W, 3) uint8 at the original size:
    both frames resized to model_hw (cv2 bilinear), FlowNet2, the flow
    resized back without rescaling its magnitude
    (calc_optical_flow.py's protocol). -> (B, H, W, 2) float32."""
    H, W = f0.shape[1:3]
    mh, mw = model_hw
    r0 = resize(f0.permute(0, 3, 1, 2).float(), mh, mw)
    r1 = resize(f1.permute(0, 3, 1, 2).float(), mh, mw)
    flow = flownet2(sd, torch.stack([r0, r1], 1), lowp)
    return resize(flow, H, W).permute(0, 2, 3, 1)
