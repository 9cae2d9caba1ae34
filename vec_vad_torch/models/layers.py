"""Completion-network building blocks for an ensemble of E members
(vec_vad_tpu/models/layers.py).

The JAX package runs the erased-position ensemble as one UNet vmapped over
stacked parameters. Here the E members run as ONE network of grouped
convolutions: activations are NCHW with E*C channels, member-major, and
every convolution uses groups=E, so the whole ensemble is one launch per
layer. Semantics per member are torch's defaults, which layers.py
replicates:

  * Conv2d 3x3 'same' / 1x1;
  * ConvTranspose2d(k=3, s=2, p=1, output_padding=1), weight (I, O, kh, kw);
  * BatchNorm2d with eps 1e-5: eval mode uses the running statistics;
    train mode uses the batch statistics over (B, H, W) per member-channel
    and updates the running statistics with momentum 0.1 and the
    UNBIASED batch variance n/(n-1), optionally over the rows a (B,) 0/1
    `batch_weight` marks (masked_bn, vec_vad_tpu/models/layers.py:101-148);
  * MaxPool2d(2).

A bf16 input (bf16 training, bf16 scoring) runs BatchNorm with the JAX
package's bf16 cast points (`BatchNorm._forward_low_precision`).

Inside a mesh step (parallel.mesh.run_replicas) each replica holds a
share of the batch, and a train-mode BatchNorm takes its statistics over
the whole batch, as JAX's SPMD step does (`BatchNorm._forward_mesh`).

Parameters are created empty on `device`; weights come from
models/convert.py or `init_completion_`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vec_vad_torch.device import resolve_device
from vec_vad_torch.parallel.mesh import all_reduce, in_mesh_step


def _prefix(t: torch.Tensor, n: int) -> torch.Tensor:
    """The first n rows of t (t itself when it has n): the members of the
    blocks a grid step runs."""
    return t if t.shape[0] == n else t[:n]


class Conv(nn.Module):
    """E grouped k x k 'same' convolutions; weight (E*O, I, k, k)."""

    def __init__(self, members, in_ch, features, kernel_size=3, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        k = kernel_size
        self.members, self.padding = members, k // 2
        self.in_ch, self.features = in_ch, features
        self.weight = nn.Parameter(
            torch.empty(members * features, in_ch, k, k, device=dev)
        )
        self.bias = nn.Parameter(torch.empty(members * features, device=dev))

    def forward(self, x):
        m = x.shape[1] // self.in_ch
        n = m * self.features
        return F.conv2d(x, _prefix(self.weight, n), _prefix(self.bias, n), 1,
                        self.padding, 1, m)


class ConvTranspose2x(nn.Module):
    """E grouped ConvTranspose2d(k=3, s=2, p=1, output_padding=1): doubles
    the spatial size (model/unet.py:54); weight (E*I, O, 3, 3)."""

    def __init__(self, members, in_ch, features, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.members, self.in_ch, self.features = members, in_ch, features
        self.weight = nn.Parameter(
            torch.empty(members * in_ch, features, 3, 3, device=dev)
        )
        self.bias = nn.Parameter(torch.empty(members * features, device=dev))

    def forward(self, x):
        m = x.shape[1] // self.in_ch
        return F.conv_transpose2d(x, _prefix(self.weight, x.shape[1]),
                                  _prefix(self.bias, m * self.features),
                                  2, 1, 1, m)


class BatchNorm(nn.Module):
    """BatchNorm2d over E*F channels with torch's running-stat semantics.

    batch_weight (optional, (B,) 0/1, train mode only): the batch
    statistics cover only the weighted rows, so a wrap-padded batch trains
    exactly like the bare partial batch (the reference trains its final
    batch unpadded, train.py:383-402). Rows with weight 0 are still
    normalised, by the weighted rows' statistics. A (G, B) batch_weight
    splits the channels into G equal runs (a grid's blocks), run g's
    statistics over the rows of mask row g.

    An input narrower than the layer (a grid step over its first blocks)
    uses and updates the first x.shape[1] channels' parameters and
    running statistics only.

    In train mode inside a mesh step the statistics are the whole batch's
    over every replica's rows (_forward_mesh); a (B,) batch_weight then
    marks this replica's rows."""

    def __init__(self, members, features, momentum=0.1, epsilon=1e-5,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        n = members * features
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(n, device=dev))
        self.bias = nn.Parameter(torch.zeros(n, device=dev))
        self.register_buffer("running_mean", torch.zeros(n, device=dev))
        self.register_buffer("running_var", torch.ones(n, device=dev))

    def _params(self, c: int):
        """(weight, bias, running_mean, running_var) of the first c channels."""
        return tuple(_prefix(t, c) for t in (self.weight, self.bias,
                                             self.running_mean, self.running_var))

    def forward(self, x, train: bool = False, batch_weight=None):
        if train and in_mesh_step():
            return self._forward_mesh(x, batch_weight)
        if x.dtype != torch.float32:
            return self._forward_low_precision(x, train, batch_weight)
        weight, bias, r_mean, r_var = self._params(x.shape[1])
        if not train or batch_weight is None:
            # torch's own batch norm: batch statistics in train mode, the
            # running ones updated with the unbiased variance
            return F.batch_norm(x, r_mean, r_var, weight, bias, train,
                                self.momentum, self.epsilon)
        mean, var, n = _masked_stats(x, batch_weight)
        with torch.no_grad():
            m = self.momentum
            unbias = n / torch.clamp(n - 1.0, min=1.0)
            r_mean.mul_(1 - m).add_(m * mean)
            r_var.mul_(1 - m).add_(m * var * unbias)
        inv = torch.rsqrt(var + self.epsilon)
        return ((x - mean[:, None, None]) * (inv * weight)[:, None, None]
                + bias[:, None, None])

    def _forward_low_precision(self, x, train: bool, batch_weight):
        """A bf16 x with the JAX package's cast points
        (vec_vad_tpu/models/layers.py:125-144): the statistics come out in
        x's dtype (sums accumulate in f32, as both libraries reduce bf16),
        the normalisation runs in x's dtype against the weight and bias as
        given (bf16 copies of the f32 masters while training), and the
        running statistics stay in their own dtype (f32 while training)."""
        dims = (0, 2, 3)
        weight, bias, r_mean, r_var = self._params(x.shape[1])
        if not train:
            mean = r_mean.to(x.dtype)
            var = r_var.to(x.dtype)
        else:
            if batch_weight is None:
                n = float(x.numel() // x.shape[1])
                mean = x.mean(dim=dims)
                var = (x - mean[:, None, None]).square().mean(dim=dims)
                var_unbiased = var * (n / max(n - 1.0, 1.0))
            else:
                # the statistics stay in the compute dtype; the f32 count
                # promotes the variance (jnp's array promotion)
                mean, var, n = _masked_stats(x, batch_weight)
                var_unbiased = var.float() * (n / torch.clamp(n - 1.0, min=1.0))
            m = self.momentum
            with torch.no_grad():
                r_mean.mul_(1 - m).add_(m * mean.detach())
                r_var.mul_(1 - m).add_(m * var_unbiased.detach())
        inv = torch.rsqrt(var + self.epsilon)
        return ((x - mean[:, None, None]) * inv[:, None, None]
                * weight[:, None, None] + bias[:, None, None])

    def _forward_mesh(self, x, batch_weight):
        """Train mode on a mesh: the weighted count and sum of x and then
        the weighted sum of squared deviations from the global mean, each
        summed over the replicas (parallel.mesh.all_reduce:
        differentiable copies reduced in mesh order), so the mean and the
        variance (the mean squared deviation, two passes as in JAX) are
        the whole batch's and the gradient flows through them. The sums
        run in f32 and the statistics come out in x's dtype (a bf16 x
        keeps _forward_low_precision's cast points). The running
        statistics update from the global values, equal on every
        replica. No batch_weight weighs every row 1."""
        B, C, H, W = x.shape
        dt = x.dtype
        weight, bias, r_mean, r_var = self._params(C)
        w = (torch.ones(B, device=x.device) if batch_weight is None
             else batch_weight.reshape(B).float())
        wx = w.to(dt)[:, None, None, None]
        s1 = torch.cat([(x * wx).float().sum(dim=(0, 2, 3)), (w.sum() * (H * W))[None]])
        s1 = all_reduce(s1)
        n = torch.clamp(s1[C], min=1.0)
        n_x = n.to(dt)
        mean = s1[:C].to(dt) / n_x
        sq_dev = (wx * (x - mean[:, None, None]).square()).float().sum(dim=(0, 2, 3))
        var = all_reduce(sq_dev).to(dt) / n_x
        with torch.no_grad():
            m = self.momentum
            unbias = n / torch.clamp(n - 1.0, min=1.0)
            r_mean.mul_(1 - m).add_(m * mean.float())
            r_var.mul_(1 - m).add_(m * var.float() * unbias)
        inv = torch.rsqrt(var + self.epsilon)
        if dt == torch.float32:
            return ((x - mean[:, None, None]) * (inv * weight)[:, None, None]
                    + bias[:, None, None])
        return ((x - mean[:, None, None]) * inv[:, None, None]
                * weight[:, None, None] + bias[:, None, None])


def _masked_stats(x, batch_weight):
    """(mean, var, n) per channel of an (B, C, H, W) x over the rows a (B,)
    or (G, B) 0/1 batch_weight marks: mean and var in x's dtype, n the f32
    count of weighted elements. Mask row g covers channels
    [g*C/G, (g+1)*C/G)."""
    B, C, H, W = x.shape
    wt = batch_weight.reshape(-1, B)  # (G, B)
    G = wt.shape[0]
    w = wt.t().to(x.dtype).reshape(B, G, 1, 1, 1)
    xv = x.reshape(B, G, C // G, H, W)
    n = torch.clamp(wt.float().sum(dim=1) * (H * W), min=1.0)[:, None]  # (G, 1)
    n_x = n.to(x.dtype)
    mean = (xv * w).sum(dim=(0, 3, 4)) / n_x  # (G, C/G)
    var = (w * (xv - mean[:, :, None, None]).square()).sum(dim=(0, 3, 4)) / n_x
    return mean.reshape(C), var.reshape(C), n.expand(G, C // G).reshape(C)


class DoubleConv(nn.Module):
    """(conv3x3 -> BN -> ReLU) x 2 (model/unet.py:4-20)."""

    def __init__(self, members, in_ch, features, device="cuda"):
        super().__init__()
        self.conv0 = Conv(members, in_ch, features, device=device)
        self.bn0 = BatchNorm(members, features, device=device)
        self.conv1 = Conv(members, features, features, device=device)
        self.bn1 = BatchNorm(members, features, device=device)

    def forward(self, x, train: bool = False, batch_weight=None):
        x = F.relu(self.bn0(self.conv0(x), train, batch_weight))
        return F.relu(self.bn1(self.conv1(x), train, batch_weight))


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel_size=2) (model/unet.py:38)."""
    return F.max_pool2d(x, 2)


def _cat_members(members, a, b):
    """Per-member channel concat [a_e, b_e] of two (N, E*Ca, ...) and
    (N, E*Cb, ...) member-major tensors."""
    n, h, w = a.shape[0], a.shape[2], a.shape[3]
    y = torch.cat(
        [a.reshape(n, members, -1, h, w), b.reshape(n, members, -1, h, w)],
        dim=2,
    )
    return y.reshape(n, -1, h, w)


class UNet(nn.Module):
    """E depth-4 completion UNets (model/unet.py:73-267 single-member
    shape): inconv -> 3x(maxpool+double_conv) -> 3x(convT-up + skip
    concat + double_conv) -> 1x1 outconv. Channels f, 2f, 4f, 8f.

    forward: (N, E*in_ch, P, P) -> (N, E*out_ch, P, P), member-major (or
    the first m members: (N, m*in_ch, P, P) -> (N, m*out_ch, P, P));
    `train` and `batch_weight` go to every BatchNorm."""

    def __init__(self, members, in_ch, features_root, out_channels,
                 device="cuda"):
        super().__init__()
        E, f, d = members, features_root, device
        self.members, self.in_ch = E, in_ch
        self.down = nn.ModuleList([
            DoubleConv(E, in_ch, f, d),
            DoubleConv(E, f, 2 * f, d),
            DoubleConv(E, 2 * f, 4 * f, d),
            DoubleConv(E, 4 * f, 8 * f, d),
        ])
        self.up_t = nn.ModuleList([
            ConvTranspose2x(E, 8 * f, 4 * f, d),
            ConvTranspose2x(E, 4 * f, 2 * f, d),
            ConvTranspose2x(E, 2 * f, f, d),
        ])
        self.up = nn.ModuleList([
            DoubleConv(E, 8 * f, 4 * f, d),
            DoubleConv(E, 4 * f, 2 * f, d),
            DoubleConv(E, 2 * f, f, d),
        ])
        self.out = Conv(E, f, out_channels, kernel_size=1, device=d)

    def forward(self, x, train: bool = False, batch_weight=None):
        t, w = train, batch_weight
        m = x.shape[1] // self.in_ch
        x1 = self.down[0](x, t, w)
        x2 = self.down[1](max_pool_2x(x1), t, w)
        x3 = self.down[2](max_pool_2x(x2), t, w)
        x4 = self.down[3](max_pool_2x(x3), t, w)
        y = x4
        for skip, up_t, up in zip((x3, x2, x1), self.up_t, self.up):
            y = up(_cat_members(m, skip, up_t(y)), t, w)
        return self.out(y)
