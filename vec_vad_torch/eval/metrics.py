"""Frame-level evaluation metrics in pure NumPy: a copy of the NumPy part
of vec_vad_tpu/eval/metrics.py (tests/test_torch_isolation.py holds the
functions equal to the originals). The pixel-level criterion
(`pixel_level_*`) is not ported.

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
