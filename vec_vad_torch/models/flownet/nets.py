"""FlowNet2 component networks in PyTorch
(vec_vad_tpu/models/flownet/nets.py).

Architectures match the reference — FlowNetC (components/FlowNetC.py:10-132),
FlowNetS (FlowNetS.py:11-96), FlowNetSD (FlowNetSD.py:9-103), FlowNetFusion
(FlowNetFusion.py:9-64) — with or without BatchNorm (`with_bn`; FlowNet2
serves with_bn=False, as do the CLI and the released checkpoints).
Submodule names equal the JAX package's (and so the torch checkpoint's)
so weight carry-over is a mechanical relayout (models/convert.py).

Blocks (components/misc.py:8-44): conv = Conv2d(pad (k-1)//2) [+
BatchNorm2d(eps 1e-5, momentum 0.1)] + LeakyReLU(0.1); deconv =
ConvTranspose2d(k4, s2, p1) + LeakyReLU;
predict_flow = 3x3 conv -> 2ch. `init_flownet_` draws the reference's
init from a numpy seed: xavier_uniform weights, U(0, 1) biases
(FlowNetC.py:64-73).

Feature maps are NHWC at every module boundary, as in the JAX package.
Inside, each convolution sees the NCHW view of the NHWC tensor, which is
channels_last in memory (no copy on the PyTorch side; cuDNN may still
transpose internally for the f32 kernel it picks).

All nets return the 5-scale flow pyramid (flow2..flow6; Fusion returns
flow0) under both values of `train`. With BatchNorm, `train` normalizes
by the batch's statistics and updates the running ones (unbiased
variance, as torch and the JAX package's BatchNorm do); otherwise it
uses the running statistics. Without BatchNorm the flag changes
nothing.
Gradients flow through every net; FlowNetC's cost volume is differentiable
(`ops.correlation`, K1 forward and K2 backward on the card).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vec_vad_torch.device import resolve_device
from vec_vad_torch.models.flownet.ops import correlation


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _cat(*xs):
    return torch.cat(xs, dim=-1)


def _leaky(x):
    return F.leaky_relu(x, 0.1)


class TorchConv(nn.Module):
    """Conv2d with 'same'-style (k-1)//2 padding; weight (O, I, k, k)."""

    def __init__(self, in_ch, features, kernel_size=3, stride=1,
                 use_bias=True, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        k = kernel_size
        self.stride = stride
        self.padding = (k - 1) // 2
        self.weight = nn.Parameter(torch.empty(features, in_ch, k, k, device=dev))
        self.bias = (
            nn.Parameter(torch.empty(features, device=dev)) if use_bias else None
        )

    def forward(self, x):
        y = F.conv2d(_nchw(x), self.weight, self.bias, self.stride, self.padding)
        return _nhwc(y)


class TorchConvT4x2(nn.Module):
    """ConvTranspose2d(k=4, s=2, p=1); weight (I, O, 4, 4)."""

    def __init__(self, in_ch, features, use_bias=True, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.empty(in_ch, features, 4, 4, device=dev))
        self.bias = (
            nn.Parameter(torch.empty(features, device=dev)) if use_bias else None
        )

    def forward(self, x):
        y = F.conv_transpose2d(_nchw(x), self.weight, self.bias, 2, 1)
        return _nhwc(y)


class ConvBlock(nn.Module):
    """conv (+ BatchNorm) + LeakyReLU(0.1) (components/misc.py:8-28)."""

    def __init__(self, in_ch, features, kernel_size=3, stride=1,
                 with_bn=False, with_relu=True, device="cuda"):
        super().__init__()
        self.conv = TorchConv(in_ch, features, kernel_size, stride, device=device)
        self.bn = (
            nn.BatchNorm2d(features, eps=1e-5, momentum=0.1,
                           device=resolve_device(device))
            if with_bn else None
        )
        self.with_relu = with_relu

    def forward(self, x, train: bool = False):
        x = self.conv(x)
        if self.bn is not None:
            bn = self.bn
            if train:
                bn.num_batches_tracked.add_(1)
            x = _nhwc(F.batch_norm(
                _nchw(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                train, bn.momentum, bn.eps,
            ))
        return _leaky(x) if self.with_relu else x


class Deconv(nn.Module):
    """deconv: ConvT(k4, s2, p1) + LeakyReLU (components/misc.py:31-39)."""

    def __init__(self, in_ch, features, device="cuda"):
        super().__init__()
        self.conv = TorchConvT4x2(in_ch, features, device=device)

    def forward(self, x):
        return _leaky(self.conv(x))


class _Pyramid(nn.Module):
    """The shared FlowNetC/S/SD decoder wiring: deconvs, flow heads and
    flow upsamplers from conv6 down to flow2."""

    def _decoder(self, device, c6, c5, c4, c3, c2, up_bias, pred_in):
        self.deconv5 = Deconv(c6, 512, device)
        self.deconv4 = Deconv(c5 + 512 + 2, 256, device)
        self.deconv3 = Deconv(c4 + 256 + 2, 128, device)
        self.deconv2 = Deconv(c3 + 128 + 2, 64, device)
        for i, cin in zip((6, 5, 4, 3, 2), pred_in):
            setattr(self, f"predict_flow{i}", TorchConv(cin, 2, 3, device=device))
        for i in (6, 5, 4, 3):
            setattr(
                self, f"upsampled_flow{i}_to_{i - 1}",
                TorchConvT4x2(2, 2, use_bias=up_bias, device=device),
            )

    def _decode(self, c6, c5, c4, c3, c2, inter=None, train=False):
        inter = inter or {}

        def head(i, x):
            if i in inter:
                x = inter[i](x, train)
            return getattr(self, f"predict_flow{i}")(x)

        flow6 = self.predict_flow6(c6)
        cat5 = _cat(c5, self.deconv5(c6), self.upsampled_flow6_to_5(flow6))
        flow5 = head(5, cat5)
        cat4 = _cat(c4, self.deconv4(cat5), self.upsampled_flow5_to_4(flow5))
        flow4 = head(4, cat4)
        cat3 = _cat(c3, self.deconv3(cat4), self.upsampled_flow4_to_3(flow4))
        flow3 = head(3, cat3)
        cat2 = _cat(c2, self.deconv2(cat3), self.upsampled_flow3_to_2(flow3))
        flow2 = head(2, cat2)
        return flow2, flow3, flow4, flow5, flow6


class FlowNetC(_Pyramid):
    """x: (B, H, W, 6) — [img0, img1] channel-concat. The cost volume runs
    through `correlation`: the CUDA kernel on the card."""

    def __init__(self, with_bn=False, device="cuda"):
        super().__init__()
        d, bn = device, with_bn
        self.conv1 = ConvBlock(3, 64, 7, 2, bn, device=d)
        self.conv2 = ConvBlock(64, 128, 5, 2, bn, device=d)
        self.conv3 = ConvBlock(128, 256, 5, 2, bn, device=d)
        self.conv_redir = ConvBlock(256, 32, 1, 1, bn, device=d)
        self.conv3_1 = ConvBlock(32 + 441, 256, 3, 1, bn, device=d)
        self.conv4 = ConvBlock(256, 512, 3, 2, bn, device=d)
        self.conv4_1 = ConvBlock(512, 512, 3, 1, bn, device=d)
        self.conv5 = ConvBlock(512, 512, 3, 2, bn, device=d)
        self.conv5_1 = ConvBlock(512, 512, 3, 1, bn, device=d)
        self.conv6 = ConvBlock(512, 1024, 3, 2, bn, device=d)
        self.conv6_1 = ConvBlock(1024, 1024, 3, 1, bn, device=d)
        c5, c4, c3 = 512 + 512 + 2, 512 + 256 + 2, 256 + 128 + 2
        self._decoder(d, 1024, 512, 512, 256, 128, True,
                      (1024, c5, c4, c3, 128 + 64 + 2))

    def forward(self, x, train: bool = False):
        x1, x2 = x[..., :3], x[..., 3:]
        c1a = self.conv1(x1, train)
        c2a = self.conv2(c1a, train)
        c3a = self.conv3(c2a, train)
        c1b = self.conv1(x2, train)
        c2b = self.conv2(c1b, train)
        c3b = self.conv3(c2b, train)

        corr = _leaky(correlation(c3a.contiguous(), c3b.contiguous(), 20, 2))
        redir = self.conv_redir(c3a, train)

        c3_1 = self.conv3_1(_cat(redir, corr), train)
        c4 = self.conv4_1(self.conv4(c3_1, train), train)
        c5 = self.conv5_1(self.conv5(c4, train), train)
        c6 = self.conv6_1(self.conv6(c5, train), train)
        return self._decode(c6, c5, c4, c3_1, c2a)


class FlowNetS(_Pyramid):
    def __init__(self, input_channels=12, with_bn=False, device="cuda"):
        super().__init__()
        d, bn = device, with_bn
        self.conv1 = ConvBlock(input_channels, 64, 7, 2, bn, device=d)
        self.conv2 = ConvBlock(64, 128, 5, 2, bn, device=d)
        self.conv3 = ConvBlock(128, 256, 5, 2, bn, device=d)
        self.conv3_1 = ConvBlock(256, 256, 3, 1, bn, device=d)
        self.conv4 = ConvBlock(256, 512, 3, 2, bn, device=d)
        self.conv4_1 = ConvBlock(512, 512, 3, 1, bn, device=d)
        self.conv5 = ConvBlock(512, 512, 3, 2, bn, device=d)
        self.conv5_1 = ConvBlock(512, 512, 3, 1, bn, device=d)
        self.conv6 = ConvBlock(512, 1024, 3, 2, bn, device=d)
        self.conv6_1 = ConvBlock(1024, 1024, 3, 1, bn, device=d)
        c5, c4, c3 = 512 + 512 + 2, 512 + 256 + 2, 256 + 128 + 2
        self._decoder(d, 1024, 512, 512, 256, 128, False,
                      (1024, c5, c4, c3, 128 + 64 + 2))

    def forward(self, x, train: bool = False):
        c1 = self.conv1(x, train)
        c2 = self.conv2(c1, train)
        c3 = self.conv3_1(self.conv3(c2, train), train)
        c4 = self.conv4_1(self.conv4(c3, train), train)
        c5 = self.conv5_1(self.conv5(c4, train), train)
        c6 = self.conv6_1(self.conv6(c5, train), train)
        return self._decode(c6, c5, c4, c3, c2)


class FlowNetSD(_Pyramid):
    def __init__(self, with_bn=False, device="cuda"):
        super().__init__()
        d, bn = device, with_bn
        self.conv0 = ConvBlock(6, 64, 3, 1, bn, device=d)
        self.conv1 = ConvBlock(64, 64, 3, 2, bn, device=d)
        self.conv1_1 = ConvBlock(64, 128, 3, 1, bn, device=d)
        self.conv2 = ConvBlock(128, 128, 3, 2, bn, device=d)
        self.conv2_1 = ConvBlock(128, 128, 3, 1, bn, device=d)
        self.conv3 = ConvBlock(128, 256, 3, 2, bn, device=d)
        self.conv3_1 = ConvBlock(256, 256, 3, 1, bn, device=d)
        self.conv4 = ConvBlock(256, 512, 3, 2, bn, device=d)
        self.conv4_1 = ConvBlock(512, 512, 3, 1, bn, device=d)
        self.conv5 = ConvBlock(512, 512, 3, 2, bn, device=d)
        self.conv5_1 = ConvBlock(512, 512, 3, 1, bn, device=d)
        self.conv6 = ConvBlock(512, 1024, 3, 2, bn, device=d)
        self.conv6_1 = ConvBlock(1024, 1024, 3, 1, bn, device=d)
        c5, c4, c3, c2 = (
            512 + 512 + 2, 512 + 256 + 2, 256 + 128 + 2, 128 + 64 + 2
        )
        self.inter_conv5 = ConvBlock(c5, 512, 3, 1, bn, False, device=d)
        self.inter_conv4 = ConvBlock(c4, 256, 3, 1, bn, False, device=d)
        self.inter_conv3 = ConvBlock(c3, 128, 3, 1, bn, False, device=d)
        self.inter_conv2 = ConvBlock(c2, 64, 3, 1, bn, False, device=d)
        self._decoder(d, 1024, 512, 512, 256, 128, True,
                      (1024, 512, 256, 128, 64))

    def forward(self, x, train: bool = False):
        c0 = self.conv0(x, train)
        c1 = self.conv1_1(self.conv1(c0, train), train)
        c2 = self.conv2_1(self.conv2(c1, train), train)
        c3 = self.conv3_1(self.conv3(c2, train), train)
        c4 = self.conv4_1(self.conv4(c3, train), train)
        c5 = self.conv5_1(self.conv5(c4, train), train)
        c6 = self.conv6_1(self.conv6(c5, train), train)
        inter = {i: getattr(self, f"inter_conv{i}") for i in (5, 4, 3, 2)}
        return self._decode(c6, c5, c4, c3, c2, inter, train)


class FlowNetFusion(nn.Module):
    def __init__(self, with_bn=False, device="cuda"):
        super().__init__()
        d, bn = device, with_bn
        self.conv0 = ConvBlock(11, 64, 3, 1, bn, device=d)
        self.conv1 = ConvBlock(64, 64, 3, 2, bn, device=d)
        self.conv1_1 = ConvBlock(64, 128, 3, 1, bn, device=d)
        self.conv2 = ConvBlock(128, 128, 3, 2, bn, device=d)
        self.conv2_1 = ConvBlock(128, 128, 3, 1, bn, device=d)
        self.deconv1 = Deconv(128, 32, d)
        self.deconv0 = Deconv(128 + 32 + 2, 16, d)
        self.inter_conv1 = ConvBlock(128 + 32 + 2, 32, 3, 1, bn, False, device=d)
        self.inter_conv0 = ConvBlock(64 + 16 + 2, 16, 3, 1, bn, False, device=d)
        self.predict_flow2 = TorchConv(128, 2, 3, device=d)
        self.predict_flow1 = TorchConv(32, 2, 3, device=d)
        self.predict_flow0 = TorchConv(16, 2, 3, device=d)
        self.upsampled_flow2_to_1 = TorchConvT4x2(2, 2, device=d)
        self.upsampled_flow1_to_0 = TorchConvT4x2(2, 2, device=d)

    def forward(self, x, train: bool = False):
        c0 = self.conv0(x, train)
        c1 = self.conv1_1(self.conv1(c0, train), train)
        c2 = self.conv2_1(self.conv2(c1, train), train)

        flow2 = self.predict_flow2(c2)
        cat1 = _cat(c1, self.deconv1(c2), self.upsampled_flow2_to_1(flow2))
        flow1 = self.predict_flow1(self.inter_conv1(cat1, train))
        cat0 = _cat(c0, self.deconv0(cat1), self.upsampled_flow1_to_0(flow1))
        return self.predict_flow0(self.inter_conv0(cat0, train))


@torch.no_grad()
def init_flownet_(module: nn.Module, seed: int = 0) -> nn.Module:
    """The reference's init from a numpy seed: xavier_uniform weights (fan
    over kh*kw*(I+O) for both conv and transposed conv), U(0, 1) biases.
    BatchNorms keep torch's init (scale 1, shift 0, running mean 0 and
    variance 1), which is the JAX package's too."""
    rng = np.random.default_rng(seed)
    for _, m in sorted(module.named_modules(), key=lambda kv: kv[0]):
        if not isinstance(m, (TorchConv, TorchConvT4x2)):
            continue
        a, b, kh, kw = m.weight.shape
        bound = float(np.sqrt(6.0 / (kh * kw * (a + b))))
        w = rng.random(m.weight.shape, dtype=np.float32) * (2 * bound) - bound
        m.weight.copy_(torch.from_numpy(w))
        if m.bias is not None:
            m.bias.copy_(torch.from_numpy(rng.random(m.bias.shape, dtype=np.float32)))
    return module
