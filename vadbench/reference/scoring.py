"""Frame scores as test.py computes them: every box of a frame cut into a
cube over the frame's context window (and its flow window), each cube
scored by the ensemble and z-normalised, boxes whose flow is too weak
(magnitude not above motion_thr) or whose integer crop is empty dropped,
the maximum over the rest, -big_number for a frame with none.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from vadbench.reference import ensemble
from vadbench.reference.ops import sample_positions


def crop_resize_many(window: torch.Tensor, boxes: torch.Tensor, patch: int):
    """(T, C, H, W) float window, (K, 4) xyxy boxes -> (K, T, C, P, P):
    each box's edges rounded up to integers and its crop resized like
    cv2.resize INTER_LINEAR."""
    T, C, H, W = window.shape
    K, P = boxes.shape[0], patch
    e = torch.ceil(boxes.double()).long()
    y0, y1, fy = sample_positions(e[:, 1], e[:, 3], P)  # (K, P)
    x0, x1, fx = sample_positions(e[:, 0], e[:, 2], P)
    fy = fy[None, None, :, :, None]
    rows = window[:, :, y0, :] * (1 - fy) + window[:, :, y1, :] * fy  # (T, C, K, P, W)

    def cols(ix):
        return rows.gather(4, ix[None, None, :, None, :].expand(T, C, K, P, P))

    fx = fx[None, None, :, None, :]
    out = cols(x0) * (1 - fx) + cols(x1) * fx  # (T, C, K, P, P)
    return out.permute(2, 0, 1, 3, 4)


def frame_cubes(window_u8: torch.Tensor, boxes: torch.Tensor, patch: int,
                flow_window: Optional[torch.Tensor] = None):
    """One frame's cubes: window (T, H, W, 3) uint8, boxes (K, 4), flow
    window (T_of, H, W, 2) or None -> (x (K, P, P, T*3) in [0, 1], the
    raw cube rounded half to even to uint8 levels as the reference stores
    it; x_of (K, P, P, T_of*2) or None; magnitude (K,) or None: the
    squared flow summed over the cube's pixels and channels, averaged
    over its frames)."""
    K = boxes.shape[0]
    raw = crop_resize_many(window_u8.permute(0, 3, 1, 2).float(), boxes, patch)
    raw = torch.round(raw).clamp(0, 255) / 255.0  # (K, T, 3, P, P)
    x = raw.permute(0, 3, 4, 1, 2).reshape(K, patch, patch, -1)
    if flow_window is None:
        return x, None, None
    fl = crop_resize_many(flow_window.permute(0, 3, 1, 2).float(), boxes, patch)
    mag = (fl ** 2).sum(dim=(2, 3, 4)).mean(dim=1)
    x_of = fl.permute(0, 3, 4, 1, 2).reshape(K, patch, patch, -1)
    return x, x_of, mag


def degenerate(boxes: np.ndarray) -> np.ndarray:
    e = np.ceil(boxes)
    return (e[:, 2] <= e[:, 0]) | (e[:, 3] <= e[:, 1])


def cube_scores(sd, model: dict, frames: List[dict], patch: int, lowp: bool = False,
                batch: int = 1024):
    """Every box of `frames` cut into its cube and scored by the ensemble:
    (raw, flow, magnitude, owner, kept), float64 numpy arrays (N,) with
    flow and magnitude None without a flow stream, owner the index of
    each cube's frame and kept False for a box whose integer crop is
    empty. Each entry of `frames`: window (T, H, W, 3) uint8, boxes
    (K, 4) float32 numpy, flow (T_of, H, W, 2) float32 or None; all on one
    device."""
    xs, xofs, mags, owner = [], [], [], []
    for i, fr in enumerate(frames):
        b = torch.as_tensor(fr["boxes"], device=fr["window"].device)
        x, x_of, mag = frame_cubes(fr["window"], b, patch, fr.get("flow"))
        xs.append(x)
        if x_of is not None:
            xofs.append(x_of)
            mags.append(mag)
        owner.append(np.full(b.shape[0], i))
    x = torch.cat(xs)
    x_of = torch.cat(xofs) if xofs else None
    raws, flows = [], []
    for lo in range(0, x.shape[0], batch):
        xo = None if x_of is None else x_of[lo:lo + batch]
        raw, flow = ensemble.cube_scores(sd, model, x[lo:lo + batch], xo, lowp)
        raws.append(raw.double())
        flows.append(flow)

    def host(parts):
        return None if parts[0] is None else torch.cat(parts).double().cpu().numpy()

    kept = ~degenerate(np.concatenate([fr["boxes"] for fr in frames]))
    return host(raws), host(flows), host(mags) if mags else None, np.concatenate(owner), kept


def score_stats(sd, model: dict, frames: List[dict], patch: int):
    """Training-score statistics (mu_r, sd_r[, mu_o, sd_o]): the mean and
    standard deviation of the raw (and flow) scores of the cubes of
    `frames`, as a trained block's are of its own cubes."""
    raw, flow, _, _, kept = cube_scores(sd, model, frames, patch)
    stats = (float(raw[kept].mean()), float(raw[kept].std()))
    if flow is not None:
        stats += (float(flow[kept].mean()), float(flow[kept].std()))
    return stats


def frame_scores(sd, model: dict, stats, frames: List[dict], patch: int,
                 motion_thr: float, big_number: float, lowp: bool = False) -> np.ndarray:
    """(n,) float64 scores of the n `frames` (as cube_scores takes them)."""
    raw, flow, mag, owner, keep = cube_scores(sd, model, frames, patch, lowp)
    scores = ensemble.fused(raw, flow, stats, model)
    if mag is not None:
        keep = keep & (mag > motion_thr)
    out = np.full(len(frames), -big_number)
    np.maximum.at(out, owner[keep], scores[keep])
    return out


def score_gap(program: Sequence[float], reference: np.ndarray,
              big_number: float) -> float:
    """The widest gap between a program's frame scores and the
    reference's, over the standard deviation of the reference's scores
    of the frames that have a scoring box: an error measured against the
    spread that ranks frames, whatever offset the z-normalisation's
    training statistics put on the scores. A score that is not finite
    reads inf."""
    p = np.asarray(program, np.float64)
    if not np.all(np.isfinite(p)):
        return float("inf")
    scored = reference[reference > -big_number]
    scale = float(scored.std()) if scored.size > 1 else 1.0
    return float(np.abs(p - reference).max() / max(scale, 1e-30))
