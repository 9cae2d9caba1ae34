"""FlowNet2's custom ops in PyTorch (vec_vad_tpu/models/flownet/ops.py).

  * correlation — the FlowNetC cost volume. On a CUDA tensor it launches
    the hand-written kernel csrc/correlation.cu (K1, forward only in this
    slice); on a CPU tensor it runs `correlation_ref`, the plain version.
    `correlation_bwd_ref` is the plain analytic backward that the CUDA
    backward kernel (K2, a later slice) will be held to.
  * warp_bilinear — Resample2d with the CUDA kernel's corner-clamped /
    unclamped-weight convention.
  * channel_norm, upsample_bilinear (both align_corners), upsample_nearest.

Everything NHWC, as in the JAX package.
"""

from __future__ import annotations

import ctypes

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
    n = 2 * max_disp // stride + 1
    if stride <= 0 or max_disp < 0 or n > 24 or max_disp > 148:
        raise ValueError(
            f"correlation kernel takes n_disp <= 24 and max_disp <= 148, got "
            f"max_disp={max_disp}, stride={stride}"
        )
    if a.requires_grad or b.requires_grad:
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "correlation on CUDA is forward-only: its backward kernel "
                "(K2, correlation_bwd_pallas's port) is not written yet; "
                "run under torch.no_grad()"
            )


def correlation_kernel(
    a: torch.Tensor, b: torch.Tensor, max_disp: int = 20, stride: int = 2
) -> torch.Tensor:
    """Launch csrc/correlation.cu on CUDA tensors (no fallback)."""
    _check_kernel_inputs(a, b, max_disp, stride)
    B, H, W, C = a.shape
    n = 2 * max_disp // stride + 1
    out = torch.empty((B, H, W, n * n), dtype=a.dtype, device=a.device)
    fn = kernels.load_library("correlation").vv_correlation_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), _KERNEL_DTYPES[a.dtype],
            B, H, W, C, max_disp, stride, stream,
        )
    if err != 0:
        raise RuntimeError(f"correlation kernel launch failed: CUDA error {err}")
    kernels.launch_counts["correlation"] += 1
    return out


def correlation(
    a: torch.Tensor, b: torch.Tensor, max_disp: int = 20, stride: int = 2
) -> torch.Tensor:
    """FlowNetC cost volume: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors; anything else raises."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return correlation_ref(a, b, max_disp, stride)
    return correlation_kernel(a, b, max_disp, stride)


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
    xl = x0.long()
    yt = y0.long()
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


def channel_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-pixel L2 norm over channels -> (..., 1)
    (ChannelNorm_kernel.cu:19-51)."""
    return torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))


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
