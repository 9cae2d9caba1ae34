"""Test-time score normalization, fusion and aggregation: a copy of the
host (NumPy) part of vec_vad_tpu/score/scoring.py, kept here so the port
imports nothing of the JAX package (tests/test_torch_isolation.py holds
the functions equal to the originals), and `splat_score_masks_device`,
the device splat, in torch.

Reference semantics (test.py:269-358):
  * per-cube MSE scores z-normalized by the block's TRAINING score mean/std
    (test.py:300-302,338-340)
  * two-stream fusion: w_raw * raw + w_of * of (test.py:304-307,342-345)
  * cubes in blocks with no trained model score big_number = 100000
    (test.py:308-310,346-348)
  * scores splat into an (h, w) pixel mask initialized at -big_number,
    running elementwise max over boxes (test.py:350-357); the frame-level
    score is the mask max (test.py:392)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vec_vad_torch.device import resolve_device

BIG_NUMBER = 100000.0  # test.py:196


def fuse_scores(
    raw_scores: np.ndarray,
    of_scores: Optional[np.ndarray],
    raw_stats: Tuple[float, float],
    of_stats: Optional[Tuple[float, float]],
    w_raw: float,
    w_of: float,
) -> np.ndarray:
    """Z-normalize each stream by its training stats and fuse."""
    mu_r, sd_r = raw_stats
    fused = w_raw * ((raw_scores - mu_r) / sd_r)
    if of_scores is not None and of_stats is not None:
        mu_o, sd_o = of_stats
        fused = fused + w_of * ((of_scores - mu_o) / sd_o)
    return fused


def degenerate_boxes(boxes: np.ndarray) -> np.ndarray:
    """Boxes whose integer-ceil crop region is empty. The reference still
    scores such cubes but their mask splat covers zero pixels
    (test.py:354-356), so they never influence the frame max."""
    x0 = np.ceil(boxes[:, 0])
    y0 = np.ceil(boxes[:, 1])
    x1 = np.ceil(boxes[:, 2])
    y1 = np.ceil(boxes[:, 3])
    return (x1 <= x0) | (y1 <= y0)


def frame_scores_from_cubes(
    cube_scores: np.ndarray,
    frame_ids: np.ndarray,
    n_frames: int,
    big_number: float = BIG_NUMBER,
    boxes: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-frame max over cube scores; frames with no cubes get -big_number
    (the untouched mask init, test.py:276). When `boxes` are given, cubes
    with an empty splat region are excluded — matching the pixel-mask max
    exactly."""
    out = np.full(n_frames, -big_number, dtype=np.float64)
    if boxes is not None:
        keep = ~degenerate_boxes(np.asarray(boxes))
        cube_scores = cube_scores[keep]
        frame_ids = frame_ids[keep]
    np.maximum.at(out, frame_ids, cube_scores)
    return out


def normalize_scores_per_video(
    frame_scores: np.ndarray,
    frame_video_idx: np.ndarray,
    big_number: float = BIG_NUMBER,
) -> np.ndarray:
    """Min-max normalize frame scores within each video.

    An optional evaluation variant common in the VAD literature (the
    reference itself normalizes only by training-score statistics); frames
    with no cubes (score -big_number) map to 0 and are excluded from each
    video's min/max.
    """
    out = np.zeros_like(frame_scores, dtype=np.float64)
    for v in np.unique(frame_video_idx):
        sel = frame_video_idx == v
        s = frame_scores[sel].astype(np.float64)
        valid = s > -big_number
        if valid.any():
            lo, hi = s[valid].min(), s[valid].max()
            rng = hi - lo if hi > lo else 1.0
            s = np.where(valid, (s - lo) / rng, 0.0)
        else:
            s = np.zeros_like(s)
        out[sel] = s
    return out


def splat_score_masks(
    cube_scores: np.ndarray,
    boxes: np.ndarray,
    frame_ids: np.ndarray,
    n_frames: int,
    frame_hw: Tuple[int, int],
    big_number: float = BIG_NUMBER,
) -> np.ndarray:
    """Full per-frame pixel score masks (test.py:350-358).

    boxes: (M, 4) xyxy; the splat region uses integer-ceil edges like the
    reference (test.py:354-356). Returns (n_frames, h, w) float32.
    """
    h, w = frame_hw
    masks = np.full((n_frames, h, w), -big_number, dtype=np.float32)
    x0 = np.ceil(boxes[:, 0]).astype(np.int64)
    y0 = np.ceil(boxes[:, 1]).astype(np.int64)
    x1 = np.ceil(boxes[:, 2]).astype(np.int64)
    y1 = np.ceil(boxes[:, 3]).astype(np.int64)
    for m in range(cube_scores.shape[0]):
        f = frame_ids[m]
        region = masks[f, y0[m] : y1[m], x0[m] : x1[m]]
        np.maximum(region, cube_scores[m], out=region)
    return masks


def splat_score_masks_device(
    cube_scores: np.ndarray,
    boxes: np.ndarray,
    frame_ids: np.ndarray,
    n_frames: int,
    frame_hw: Tuple[int, int],
    big_number: float = BIG_NUMBER,
    frame_chunk: int = 64,
    device="cuda",
) -> np.ndarray:
    """The splat of splat_score_masks on `device`
    (vec_vad_tpu/score/scoring.py:129-188): a per-pixel max over each
    frame's boxes through broadcast box-membership masks, `frame_chunk`
    frames a call, with the boxes' integer-ceil edges as int32. The same
    output as splat_score_masks (pipeline.pixel_score_masks uses the host
    splat: this one was slower on the H100, its masks crossing PCIe)."""
    dev = resolve_device(device)
    h, w = frame_hw
    # bucket cubes by frame into a padded (n_frames, K) layout
    order = np.argsort(frame_ids, kind="stable")
    fids = frame_ids[order]
    counts = np.bincount(fids, minlength=n_frames)
    K = max(int(counts.max()), 1) if counts.size else 1
    slot = np.zeros_like(fids)
    if fids.size:
        starts = np.r_[0, np.cumsum(counts)[:-1]]
        slot = np.arange(fids.size) - starts[fids]
    sc_pad = np.full((n_frames, K), -big_number, np.float32)
    bx_pad = np.zeros((n_frames, K, 4), np.float32)
    sc_pad[fids, slot] = cube_scores[order]
    bx_pad[fids, slot] = boxes[order]

    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    out = np.empty((n_frames, h, w), np.float32)
    for lo in range(0, n_frames, frame_chunk):
        sc = torch.from_numpy(sc_pad[lo: lo + frame_chunk]).to(dev)
        edges = torch.ceil(torch.from_numpy(bx_pad[lo: lo + frame_chunk]).to(dev))
        x0, y0, x1, y1 = (edges[..., i].to(torch.int32)[..., None, None]
                          for i in range(4))
        inside = (xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1)  # (B, K, h, w)
        vals = torch.where(inside, sc[..., None, None],
                           torch.tensor(-big_number, dtype=torch.float32, device=dev))
        out[lo: lo + frame_chunk] = vals.amax(dim=1).cpu().numpy()
    return out
