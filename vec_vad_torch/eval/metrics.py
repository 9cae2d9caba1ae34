"""Frame-level evaluation metrics in pure NumPy: a copy of the NumPy part
of vec_vad_tpu/eval/metrics.py (tests/test_torch_isolation.py holds the
functions equal to the originals), and the pixel-level criterion
(`pixel_level_scalars`, `pixel_level_roc`) with its reduction's two
routes, the host np.partition loop and a torch device route.

Drop-in replacement for the reference's sklearn-based evaluation
(utils.py:29-65): ROC curve + AUROC, EER (both directions), and PR curves
with either class as positive, against sklearn's exact curve semantics
(stable descending sort, distinct-threshold collapse, ROC
suboptimal-point dropping; ROC thresholds start at inf as in sklearn
>= 1.3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vec_vad_torch.device import resolve_device


def _binary_curve(
    scores: np.ndarray, labels: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cumulative (fps, tps, thresholds) along decreasing score thresholds,
    one entry per distinct score value."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(np.float64)
    order = np.argsort(-scores, kind="stable")
    scores = scores[order]
    labels = labels[order]
    # Collapse runs of equal scores: keep the last index of each run.
    distinct = np.where(np.diff(scores) != 0)[0]
    idxs = np.r_[distinct, scores.size - 1]
    tps = np.cumsum(labels)[idxs]
    fps = 1 + idxs - tps
    return fps, tps, scores[idxs]


def roc_curve(
    scores: np.ndarray, labels: np.ndarray, drop_intermediate: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds), matching sklearn.metrics.roc_curve."""
    fps, tps, thresholds = _binary_curve(scores, labels)
    if drop_intermediate and fps.size > 2:
        keep = np.where(
            np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        )[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    # Prepend the (0, 0) origin point.
    fps = np.r_[0.0, fps]
    tps = np.r_[0.0, tps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full_like(fps, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full_like(tps, np.nan)
    return fpr, tpr, thresholds


def precision_recall_curve(
    scores: np.ndarray, labels: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(precision, recall, thresholds), matching
    sklearn.metrics.precision_recall_curve."""
    fps, tps, thresholds = _binary_curve(scores, labels)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps > 0)
    if tps[-1] == 0:
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    # Reverse so recall is decreasing and append the (1, 0) endpoint —
    # sklearn's output convention (>=1.x without full-recall truncation).
    sl = slice(None, None, -1)
    return (
        np.r_[precision[sl], 1.0],
        np.r_[recall[sl], 0.0],
        thresholds[sl],
    )


def auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under a curve; handles decreasing x like sklearn."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    dx = np.diff(x)
    direction = 1.0
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1.0
        else:
            raise ValueError("x is neither increasing nor decreasing")
    return float(direction * np.trapezoid(y, x))


def roc_auc_score(scores: np.ndarray, labels: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(scores, labels)
    return auc(fpr, tpr)


@dataclass(frozen=True)
class EvalResult:
    roc_auc: float
    eer1: float  # fpr at the EER point (utils.py:44-46)
    eer2: float  # fnr at the EER point
    pr_auc_norm: float  # PR-AUC with "normal" as positive class
    pr_auc_anom: float  # PR-AUC with "anomaly" as positive class
    curves: Dict[str, np.ndarray]


def evaluate_scores(scores: np.ndarray, labels: np.ndarray) -> EvalResult:
    """Full frame-level evaluation (parity with utils.py:29-65).

    `labels` are truthy for anomalous frames. Like the reference, scores are
    re-ordered into [negatives, positives] before curve computation (the
    ordering only affects tie-breaking inside stable sort).
    """
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel()
    pos = scores[labels == 1]
    neg = scores[labels != 1]
    if pos.size == 0 or neg.size == 0:
        raise ValueError(
            "evaluate_scores needs both classes present; got "
            f"{pos.size} anomalous and {neg.size} normal frames"
        )
    truth = np.r_[np.zeros_like(neg), np.ones_like(pos)]
    preds = np.r_[neg, pos]

    fpr, tpr, roc_thresholds = roc_curve(preds, truth)
    roc_auc = auc(fpr, tpr)

    fnr = 1.0 - tpr
    i = int(np.nanargmin(np.abs(fnr - fpr)))
    eer1, eer2 = float(fpr[i]), float(fnr[i])

    p_n, r_n, t_n = precision_recall_curve(preds, truth)
    pr_auc_norm = auc(r_n, p_n)
    p_a, r_a, t_a = precision_recall_curve(-preds, 1 - truth)
    pr_auc_anom = auc(r_a, p_a)

    curves = dict(
        preds=preds, truth=truth, fpr=fpr, tpr=tpr,
        roc_thresholds=roc_thresholds, roc_auc=np.float64(roc_auc),
        precision_norm=p_n, recall_norm=r_n, pr_thresholds_norm=t_n,
        pr_auc_norm=np.float64(pr_auc_norm),
        precision_anom=p_a, recall_anom=r_a, pr_thresholds_anom=t_a,
        pr_auc_anom=np.float64(pr_auc_anom),
    )
    return EvalResult(roc_auc, eer1, eer2, pr_auc_norm, pr_auc_anom, curves)


def save_roc_pr_curve_data(
    scores: np.ndarray,
    labels: np.ndarray,
    file_path: Optional[str],
    verbose: bool = True,
) -> float:
    """Evaluate and persist curves as .npz (parity with utils.py:29-65).

    Returns the frame-level AUROC.
    """
    res = evaluate_scores(scores, labels)
    if verbose:
        print(
            "AUC@ROC is {}".format(res.roc_auc),
            "EER1 is {}".format(res.eer1),
            "EER2 is {}".format(res.eer2),
        )
    if file_path is not None:
        np.savez_compressed(file_path, **res.curves)
    return res.roc_auc


# ---------------------------------------------------------------------------
# Pixel-level criterion (vec_vad_tpu/eval/metrics.py:187-304)
# ---------------------------------------------------------------------------

# frames per device call: bounds the (chunk, H*W) f32 sort workspace to
# ~50-200 MB at SHT geometry
_PIXEL_DEVICE_CHUNK = 32


def _pixel_scalars_device(
    flat: np.ndarray, gt_flat: np.ndarray, coverage: float, device="cuda"
) -> np.ndarray:
    """Device twin of the pixel_level_scalars reduction on `device`: one
    masked descending sort and a clamped per-row gather of the k-th
    element, a chunk of frames a call.

    Exact against the host np.partition loop: both select an element of
    the frame. Anomalous frames mask their non-GT pixels to -inf, so the
    k-th largest of the sorted row is the k-th largest inside the GT
    region (k <= |GT|, so the gather never reaches the -inf tail); normal
    frames keep the whole row and take k = 1, the max. k is computed on
    the HOST in f64, as the host loop computes it: f32 ceil disagrees for
    some (coverage, |GT|) pairs (0.3 * 50: 15.000000000000002 in f64 ->
    16, 15.0 in f32 -> 15)."""
    dev = resolve_device(device)
    n = flat.shape[0]
    c = _PIXEL_DEVICE_CHUNK
    out = np.empty(n, np.float64)
    for lo in range(0, n, c):
        s = torch.from_numpy(np.ascontiguousarray(flat[lo: lo + c], np.float32)).to(dev)
        g_host = gt_flat[lo: lo + c]
        g = torch.from_numpy(np.ascontiguousarray(g_host)).to(dev)
        cnt = g_host.sum(axis=-1)
        k = np.where(cnt > 0, np.ceil(coverage * cnt.astype(np.float64)), 1.0)
        k = np.clip(k, 1, np.maximum(cnt, 1)).astype(np.int64)
        lab = g.any(dim=-1, keepdim=True)
        masked = torch.where(lab & ~g, torch.tensor(-np.inf, device=dev), s)
        top = torch.sort(masked, dim=-1, descending=True).values
        ki = torch.as_tensor(k - 1, device=dev).clamp(0, top.shape[-1] - 1)
        out[lo: lo + c] = top.gather(-1, ki[:, None])[:, 0].cpu().numpy()
    return out


def pixel_level_scalars(
    score_masks: np.ndarray,
    gt_masks: np.ndarray,
    coverage: float = 0.4,
    on_device: bool = False,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Reduce per-pixel score masks to per-frame scalars implementing the
    standard VAD pixel-level criterion (Mahadevan et al., CVPR'10; the
    reference stubs every non-frame criterion with NotImplementedError,
    test.py:400-401).

    An anomalous frame counts as detected at threshold t iff the predicted
    anomalous pixels (score >= t) cover >= `coverage` of its GT anomalous
    pixels; a normal frame is a false positive iff ANY pixel fires. Both
    rules are monotone in t, so each frame reduces to one scalar:

      * anomalous frame: the k-th largest score inside the GT region,
        k = ceil(coverage * |GT|)  (detected iff t <= that value);
      * normal frame:    the max score over the whole frame.

    The pixel-level ROC is the ordinary score ROC over these scalars.
    Returns (scalars, labels).

    `on_device` picks the reduction's route (the JAX package's `device`
    flag; here `device` names the torch device): True runs the chunked
    sorts on `device` (_pixel_scalars_device, element-exact against the
    host loop); False, the default, the host np.partition loop, which
    touches no device. Unlike the JAX package, nothing routes by size:
    the device route was slower than the host's on the H100 at every size
    measured, its masks crossing PCIe (PERF.md section 5).
    """
    # No dtype conversion: both reductions are order-based selection, and
    # an up-front float64 copy would double an SHT-scale mask stack
    score_masks = np.asarray(score_masks)
    gt = np.asarray(gt_masks) > 0
    n = score_masks.shape[0]
    if gt.shape[0] != n:
        raise ValueError(f"{n} score masks vs {gt.shape[0]} GT masks")
    labels = gt.reshape(n, -1).any(axis=1).astype(np.int64)
    flat = score_masks.reshape(n, -1)
    if on_device:
        return (
            _pixel_scalars_device(flat, gt.reshape(n, -1), coverage, device),
            labels,
        )
    scalars = np.empty(n, np.float64)
    for i in range(n):
        if labels[i]:
            region = flat[i][gt[i].reshape(-1)]
            k = max(int(np.ceil(coverage * region.size)), 1)
            # k-th largest
            scalars[i] = np.partition(region, region.size - k)[region.size - k]
        else:
            scalars[i] = flat[i].max()
    return scalars, labels


def pixel_level_roc(
    score_masks: np.ndarray,
    gt_masks: np.ndarray,
    coverage: float = 0.4,
    file_path: Optional[str] = None,
) -> float:
    """Pixel-level AUROC under the coverage criterion (see
    pixel_level_scalars; its host route); persists the ROC/PR curves like
    save_roc_pr_curve_data when `file_path` is given."""
    scalars, labels = pixel_level_scalars(score_masks, gt_masks, coverage)
    return save_roc_pr_curve_data(scalars, labels, file_path, verbose=False)
