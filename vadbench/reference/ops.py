"""Layer primitives of the reference, NCHW, with an optional TF32 operand
rounding for the control."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to TF32 (10 explicit mantissa bits), to
    nearest: what the tensor cores do to a convolution's operands. The
    gradient passes straight through the rounding."""
    i = t.detach().contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t).detach() if t.requires_grad else r


def conv(x, w, b=None, stride=1, pad=None, lowp=False):
    pad = (w.shape[-1] - 1) // 2 if pad is None else pad
    if lowp:
        x, w = tf32(x), tf32(w)
    return F.conv2d(x, w, b, stride, pad)


def convt(x, w, b=None, stride=2, pad=1, outpad=0, lowp=False):
    if lowp:
        x, w = tf32(x), tf32(w)
    return F.conv_transpose2d(x, w, b, stride, pad, outpad)


def leaky(x):
    return torch.where(x >= 0, x, 0.1 * x)


def sample_positions(lo, hi, out_size: int):
    """cv2 INTER_LINEAR's source taps for resizing the crop [lo, hi) of an
    axis to out_size: (i0, i1, frac), each (..., out_size), with
    half-pixel centres and the position clamped into the crop. An empty
    crop samples index lo."""
    lo = lo.long()
    hi = torch.maximum(hi.long(), lo + 1)
    n = (hi - lo).double()[..., None]
    j = torch.arange(out_size, dtype=torch.float64, device=lo.device)
    src = ((j + 0.5) * n / out_size - 0.5).clamp(min=0.0)
    src = torch.minimum(src, n - 1.0)
    f = torch.floor(src)
    i0 = f.long() + lo[..., None]
    i1 = torch.minimum(i0 + 1, hi[..., None] - 1)
    return i0, i1, (src - f).float()


def resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize INTER_LINEAR of a (B, C, H, W) float stack, without
    antialiasing, in float32."""
    B, C, H, W = img.shape
    dev = img.device
    zero = torch.zeros((), dtype=torch.long, device=dev)
    y0, y1, fy = sample_positions(zero, zero + H, out_h)
    x0, x1, fx = sample_positions(zero, zero + W, out_w)
    rows = (img[:, :, y0, :] * (1 - fy)[:, None] + img[:, :, y1, :] * fy[:, None])
    return rows[..., x0] * (1 - fx) + rows[..., x1] * fx
