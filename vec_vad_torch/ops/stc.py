"""Spatio-temporal cube (STC) extraction on the device
(vec_vad_tpu/ops/stc.py).

Replaces the reference's per-bbox CPU hot loop (`get_foreground`,
vad_datasets.py:70-93): integer-ceil box edges, crop the same box from every
frame of the temporal window, bilinear-resize each crop to patch_size².
As in the JAX package, each crop-resize is two small matrix products with
interpolation matrices built from the box coordinates:

    patch[k, t, p, q, c] = sum_{h, w} My[k, p, h] * window[t, h, w, c] * Mx[k, q, w]

Sampling follows cv2.resize INTER_LINEAR's half-pixel-center convention
with edge clamping. Products run in full f32 (no TF32). `pad_boxes`
(NumPy) pads a split's ragged per-frame box lists to a dense set.
"""

from __future__ import annotations

import numpy as np
import torch


def _interp_matrix(lo, hi, src_size: int, out_size: int) -> torch.Tensor:
    """(..., out_size, src_size) bilinear interpolation matrices sampling
    the half-open crops [lo, hi) with cv2's half-pixel-center convention.

    lo/hi are int tensors of any batch shape (already integer-ceil'd box
    edges, vad_datasets.py:74-75). Degenerate crops (hi <= lo) sample
    column `lo`."""
    lo = lo.to(torch.int32)
    hi = torch.maximum(hi.to(torch.int32), lo + 1)
    crop = (hi - lo).to(torch.float32)[..., None]
    j = torch.arange(out_size, dtype=torch.float32, device=lo.device)
    # cv2 convention: src = (dst + 0.5) * scale - 0.5, clamped to the crop.
    pos = (j + 0.5) * crop / out_size - 0.5
    pos = torch.minimum(torch.clamp(pos, min=0.0), crop - 1.0)
    i0f = torch.floor(pos)
    frac = pos - i0f
    i0 = i0f.to(torch.int32) + lo[..., None]
    i1 = torch.minimum(i0 + 1, hi[..., None] - 1)
    cols = torch.arange(src_size, dtype=torch.int32, device=lo.device)
    m = torch.where(cols == i0[..., None], 1.0 - frac[..., None], 0.0)
    return m + torch.where(cols == i1[..., None], frac[..., None], 0.0)


def extract_stc(
    window: torch.Tensor,
    boxes: torch.Tensor,
    patch_size: int = 32,
    quantize: bool = False,
) -> torch.Tensor:
    """Crop-resize a padded (K, 4) xyxy box set from every frame of a
    (T, H, W, C) float or uint8 window; with leading batch dims, a
    (..., T, H, W, C) window stack and a (..., K, 4) box stack.

    Returns (..., K, T, P, P, C) float32 cubes; `quantize` rounds
    half-to-even like the reference's uint8 cube storage. Rows for padded
    boxes hold garbage; callers mask them with their validity vector."""
    H, W = window.shape[-3:-1]
    e = torch.ceil(boxes.float()).to(torch.int32)
    my = _interp_matrix(e[..., 1], e[..., 3], H, patch_size)  # (..., K, P, H)
    mx = _interp_matrix(e[..., 0], e[..., 2], W, patch_size)  # (..., K, P, W)
    win = window.float()
    rows = torch.einsum("...kph,...thwc->...ktpwc", my, win)
    patch = torch.einsum("...ktpwc,...kqw->...ktpqc", rows, mx)
    if quantize:
        patch = torch.round(patch)
    return patch


def crop_resize_cube(window, box, patch_size: int = 32, quantize: bool = False):
    """One box: (T, H, W, C) window, (4,) box -> (T, P, P, C)."""
    return extract_stc(window, box.reshape(1, 4), patch_size, quantize)[0]


def cube_to_input(cubes: torch.Tensor, scale: bool) -> torch.Tensor:
    """(..., T, P, P, C) -> (..., P, P, T*C), T-major channel order — the
    reference's (H, W, T·C) reshape + ToTensor (vad_datasets.py:148-166).
    `scale=True` applies the uint8 -> [0, 1] scaling."""
    t = cubes.dim() - 4
    perm = list(range(t)) + [t + 1, t + 2, t, t + 3]
    x = cubes.permute(perm)
    x = x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
    return x / 255.0 if scale else x


def flow_magnitude(flow_cubes: torch.Tensor) -> torch.Tensor:
    """Per-cube motion magnitude for the motion filter (train.py:167-178):
    sum of squared flow over (H, W, C), averaged over time.
    (K, T, P, P, 2) -> (K,)"""
    return torch.mean(
        torch.sum(flow_cubes.float() ** 2, dim=(-3, -2, -1)), dim=-1
    )


def pad_boxes(
    boxes_list, max_boxes: int
) -> "tuple[np.ndarray, np.ndarray]":
    """Pad a ragged per-frame list of (K_i, 4) box arrays to a dense
    (N, max_boxes, 4) array + (N, max_boxes) validity mask.

    This is the static-shape bridge for the reference's object-array bbox
    files (raw_datasets/*/bboxes_*.npy)."""
    n = len(boxes_list)
    out = np.zeros((n, max_boxes, 4), dtype=np.float32)
    valid = np.zeros((n, max_boxes), dtype=bool)
    for i, b in enumerate(boxes_list):
        b = np.asarray(b, dtype=np.float32).reshape(-1, 4)
        k = min(b.shape[0], max_boxes)
        if b.shape[0] > max_boxes:
            raise ValueError(
                f"frame {i} has {b.shape[0]} boxes > max_boxes={max_boxes}"
            )
        out[i, :k] = b[:k]
        valid[i, :k] = True
    return out, valid
