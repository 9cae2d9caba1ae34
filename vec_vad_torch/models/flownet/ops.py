"""FlowNet2's custom ops in PyTorch (vec_vad_tpu/models/flownet/ops.py).

  * correlation — the FlowNetC cost volume, differentiable (a
    torch.autograd.Function that saves only its inputs). On CUDA tensors
    its forward launches csrc/correlation.cu (K1) and its backward
    csrc/correlation_bwd.cu (K2); on CPU tensors they run the plain
    versions `correlation_ref` and `correlation_bwd_ref`.
  * warp_bilinear — Resample2d with the CUDA kernel's corner-clamped /
    unclamped-weight convention.
  * channel_norm (with the reference kernel's backward, finite at 0),
    upsample_bilinear (both align_corners), upsample_nearest.

Everything NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vec_vad_torch import kernels

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Correlation cost volume
# ---------------------------------------------------------------------------


def _displacements(max_disp: int, stride: int):
    return list(range(-max_disp, max_disp + 1, stride))


def correlation_ref(
    a: torch.Tensor, b: torch.Tensor, max_disp: int = 20, stride: int = 2
) -> torch.Tensor:
    """Plain cost volume (the kernel's exact semantics).

    a, b: (B, H, W, C). Output (B, H, W, D) with D = (2*max_disp/stride+1)^2
    and channel (dy_i * n + dx_i) ordered dy-major, b zero outside the
    frame, normalization 1/C. Dtype-preserving with the channel dot
    accumulated in f32."""
    B, H, W, C = a.shape
    p = max_disp
    a32 = a.float()
    bp = F.pad(b.float(), (0, 0, p, p, p, p))
    outs = []
    for dy in _displacements(max_disp, stride):
        for dx in _displacements(max_disp, stride):
            shifted = bp[:, p + dy : p + dy + H, p + dx : p + dx + W, :]
            outs.append(torch.sum(a32 * shifted, dim=-1))
    return (torch.stack(outs, dim=-1) / C).to(a.dtype)


def correlation_bwd_ref(a, b, g, max_disp: int = 20, stride: int = 2):
    """Plain analytic cost-volume gradients (the reference CUDA backward
    kernels' math, correlation_cuda_kernel.cu:108-290):

      grad_a[y,x,c] = 1/C sum_d g[y,x,d]       * b[y+dy, x+dx, c]
      grad_b[y,x,c] = 1/C sum_d g[y-dy,x-dx,d] * a[y-dy, x-dx, c]

    No forward recompute; f32 accumulation, grads in the input dtypes."""
    B, H, W, C = a.shape
    p = max_disp
    a32, g32 = a.float(), g.float()
    bp = F.pad(b.float(), (0, 0, p, p, p, p))
    grad_a = torch.zeros_like(a32)
    grad_bp = torch.zeros_like(bp)
    n = len(_displacements(max_disp, stride))
    for i, dy in enumerate(_displacements(max_disp, stride)):
        for j, dx in enumerate(_displacements(max_disp, stride)):
            gd = g32[..., i * n + j : i * n + j + 1]
            ys, xs = slice(p + dy, p + dy + H), slice(p + dx, p + dx + W)
            grad_a += gd * bp[:, ys, xs, :]
            # scatter g_d * a to (y+dy, x+dx) of the padded frame
            grad_bp[:, ys, xs, :] += gd * a32
    grad_b = grad_bp[:, p : p + H, p : p + W, :]
    return (grad_a / C).to(a.dtype), (grad_b / C).to(b.dtype)


def _check_kernel_inputs(a: torch.Tensor, b: torch.Tensor, max_disp, stride):
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("correlation: a and b must lie on one CUDA device")
    if a.dtype not in _KERNEL_DTYPES or b.dtype != a.dtype:
        raise TypeError(
            f"correlation kernel takes float32 or bfloat16 pairs, got "
            f"{a.dtype}/{b.dtype}"
        )
    if a.dim() != 4 or a.shape != b.shape:
        raise ValueError(
            f"correlation: a, b must be (B, H, W, C) of one shape, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("correlation: a and b must be contiguous NHWC")
    if stride <= 0 or max_disp < 0 or 2 * max_disp // stride + 1 > 24 \
            or max_disp > 148:
        raise ValueError(
            f"correlation kernel takes n_disp <= 24 and max_disp <= 148, got "
            f"max_disp={max_disp}, stride={stride}"
        )


def correlation_kernel(
    a: torch.Tensor, b: torch.Tensor, max_disp: int = 20, stride: int = 2
) -> torch.Tensor:
    """Launch csrc/correlation.cu on CUDA tensors (no fallback)."""
    _check_kernel_inputs(a, b, max_disp, stride)
    B, H, W, C = a.shape
    n = 2 * max_disp // stride + 1
    out = torch.empty((B, H, W, n * n), dtype=a.dtype, device=a.device)
    kernels.launch("correlation", "vv_correlation_fwd",
                   (a.data_ptr(), b.data_ptr(), out.data_ptr()),
                   (_KERNEL_DTYPES[a.dtype], B, H, W, C, max_disp, stride), a.device)
    return out


def correlation_bwd_kernel(a, b, g, max_disp: int = 20, stride: int = 2):
    """Launch csrc/correlation_bwd.cu (K2) on CUDA tensors (no fallback):
    (grad_a, grad_b) in one launch, counted once."""
    _check_kernel_inputs(a, b, max_disp, stride)
    n = 2 * max_disp // stride + 1
    if not g.is_cuda or g.device != a.device:
        raise ValueError("correlation backward: g must lie on a's CUDA device")
    if g.dtype != a.dtype:
        raise TypeError(
            f"correlation backward: g is {g.dtype}, the inputs {a.dtype}"
        )
    if tuple(g.shape) != (*a.shape[:3], n * n):
        raise ValueError(
            f"correlation backward: g must be {(*a.shape[:3], n * n)}, got "
            f"{tuple(g.shape)}"
        )
    g = g.contiguous()
    B, H, W, C = a.shape
    grad_a, grad_b = torch.empty_like(a), torch.empty_like(b)
    kernels.launch("correlation_bwd", "vv_correlation_bwd",
                   (a.data_ptr(), b.data_ptr(), g.data_ptr(), grad_a.data_ptr(),
                    grad_b.data_ptr()),
                   (_KERNEL_DTYPES[a.dtype], B, H, W, C, max_disp, stride), a.device)
    return grad_a, grad_b


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def correlation_bwd(a, b, g, max_disp: int = 20, stride: int = 2):
    """The cost volume's (grad_a, grad_b): K2 on CUDA tensors, the plain
    version on CPU tensors; anything else raises."""
    if _on_cpu(a, b, g):
        return correlation_bwd_ref(a, b, g, max_disp, stride)
    return correlation_bwd_kernel(a, b, g, max_disp, stride)


class _Correlation(torch.autograd.Function):
    """The custom VJP of vec_vad_tpu's `correlation`
    (models/flownet/ops.py:317-351): saves only (a, b); the backward is
    the analytic one, with no recompute of the forward."""

    @staticmethod
    def forward(ctx, a, b, max_disp, stride):
        ctx.save_for_backward(a, b)
        ctx.disp = (max_disp, stride)
        if _on_cpu(a, b):
            return correlation_ref(a, b, max_disp, stride)
        return correlation_kernel(a, b, max_disp, stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        grad_a, grad_b = correlation_bwd(a, b, g, *ctx.disp)
        return grad_a, grad_b, None, None


def correlation(
    a: torch.Tensor, b: torch.Tensor, max_disp: int = 20, stride: int = 2
) -> torch.Tensor:
    """FlowNetC cost volume, differentiable in a and b: K1 forward and K2
    backward on CUDA tensors, the plain versions on CPU tensors; anything
    else raises."""
    return _Correlation.apply(a, b, max_disp, stride)


# ---------------------------------------------------------------------------
# Backward warp (Resample2d)
# ---------------------------------------------------------------------------


def warp_bilinear(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp img by flow: out[y, x] = img[y + v, x + u] bilinear.

    img: (B, H, W, C); flow: (B, H, W, 2) with (u, v) = (dx, dy). Sampling
    coordinates clamp into the frame and the corner indices follow, while
    the blend weights are the fractional parts of the clamped coordinates
    — the reference CUDA kernel's result (Resample2d_kernel.cu:50-62) and
    vec_vad_tpu's formulation exactly. Coordinates and weights in f32,
    result in img.dtype."""
    B, H, W, C = img.shape
    dev = img.device
    ys = torch.arange(H, dtype=torch.float32, device=dev).view(1, H, 1)
    xs = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W)
    xf = torch.clamp(xs + flow[..., 0].float(), 0, W - 1)
    yf = torch.clamp(ys + flow[..., 1].float(), 0, H - 1)
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    alpha = (xf - x0).unsqueeze(-1)
    beta = (yf - y0).unsqueeze(-1)
    # in range already unless the flow is NaN: then the output is NaN and
    # the gather stays in bounds (a device-side assert on the card)
    xl = x0.long().clamp(0, W - 1)
    yt = y0.long().clamp(0, H - 1)
    xr = torch.clamp(xl + 1, max=W - 1)
    yb = torch.clamp(yt + 1, max=H - 1)
    flat = img.reshape(B, H * W, C)

    def at(yi, xi):
        idx = (yi * W + xi).reshape(B, H * W, 1).expand(B, H * W, C)
        return torch.gather(flat, 1, idx).reshape(B, H, W, C).float()

    out = (
        (1 - alpha) * (1 - beta) * at(yt, xl)
        + alpha * (1 - beta) * at(yt, xr)
        + (1 - alpha) * beta * at(yb, xl)
        + alpha * beta * at(yb, xr)
    )
    return out.to(img.dtype)


# ---------------------------------------------------------------------------
# ChannelNorm and upsampling
# ---------------------------------------------------------------------------


class _ChannelNorm(torch.autograd.Function):
    """The reference op's forward and its backward g·x/(‖x‖+1e-9)
    (ChannelNorm_kernel.cu:54-81): finite where x is 0 at a pixel, where
    the derivative of sqrt is infinite and autodiff gives NaN."""

    @staticmethod
    def forward(ctx, x):
        norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
        ctx.save_for_backward(x, norm)
        return norm

    @staticmethod
    def backward(ctx, g):
        x, norm = ctx.saved_tensors
        return g * x / (norm + 1e-9)


def channel_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-pixel L2 norm over channels -> (..., 1)
    (ChannelNorm_kernel.cu:19-81)."""
    return _ChannelNorm.apply(x)


def upsample_bilinear(
    x: torch.Tensor, factor: int, align_corners: bool = False
) -> torch.Tensor:
    """nn.Upsample(mode='bilinear') equivalent, NHWC."""
    y = F.interpolate(
        x.permute(0, 3, 1, 2), scale_factor=factor, mode="bilinear",
        align_corners=align_corners,
    )
    return y.permute(0, 2, 3, 1)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """nn.Upsample(mode='nearest') with an integer factor == pixel repeat."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)
