"""Anomaly-segmentation metrics over numpy arrays: the scalar functions of
the reference (Dice of the thresholded square error, IoU, the thresholded
counts, the pixel ROC curve and its AUC, SSIM, PSNR) and their per-slice
batched forms over (S, H, W, C) stacks.

Own copy of `anoddpm_tpu/metrics.py`: AUC on the raw square-error map
(the batched form by the rank-sum identity, equal to the trapezoidal ROC
integral), SSIM with skimage's default algorithm (7x7 uniform window,
K1=.01, K2=.03, data range 2, border crop), and the thresholded metrics at
0.5, keeping the reference's swapped conventions: `precision` counts FP as
(real==1 & pred==0), `recall` FN as (real==0 & pred==1) and `fpr` FP as
(real==1 & pred==0); `recall_correct` and `fpr_correct` are the textbook
ones.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter
from scipy.stats import rankdata


def square_error(real, recon) -> np.ndarray:
    return (np.asarray(real) - np.asarray(recon)) ** 2


def dice_coeff(real, recon, real_mask, smooth: float = 1e-6, mse=None) -> float:
    """Dice of the square error thresholded at 0.5 against the mask, the
    mean over the batch; arrays are (B, H, W, C) or (H, W, C)."""
    real = np.asarray(real)
    real_mask = np.asarray(real_mask)
    if mse is None:
        mse = (square_error(real, recon) > 0.5).astype(np.float32)
    else:
        mse = np.asarray(mse)
    if real.ndim == 3:
        mse, real_mask = mse[None], real_mask[None]
    axes = tuple(range(1, mse.ndim))
    intersection = np.sum(mse * real_mask, axis=axes)
    union = np.sum(mse, axis=axes) + np.sum(real_mask, axis=axes)
    return float(np.mean((2.0 * intersection + smooth) / (union + smooth)))


def iou(real_mask, pred_mask) -> float:
    real_mask = np.asarray(real_mask).astype(bool)
    pred_mask = np.asarray(pred_mask).astype(bool)
    inter = np.logical_and(real_mask, pred_mask).sum()
    union = np.logical_or(real_mask, pred_mask).sum()
    return float(inter / (union + 1e-8))


def _counts(real_mask, pred_mask):
    """(real==1 & pred==1, real==1 & pred==0, real==0 & pred==1,
    real==0 & pred==0) pixel counts."""
    r, p = np.asarray(real_mask), np.asarray(pred_mask)
    return (((r == 1) & (p == 1)).sum(), ((r == 1) & (p == 0)).sum(),
            ((r == 0) & (p == 1)).sum(), ((r == 0) & (p == 0)).sum())


def precision(real_mask, pred_mask) -> float:
    """The reference's TP / (TP + FP) with FP = (real==1 & pred==0)."""
    tp, miss, _, _ = _counts(real_mask, pred_mask)
    return float(tp / (tp + miss + 1e-6))


def recall(real_mask, pred_mask) -> float:
    """The reference's TP / (TP + FN) with FN = (real==0 & pred==1)."""
    tp, _, false_alarm, _ = _counts(real_mask, pred_mask)
    return float(tp / (tp + false_alarm + 1e-6))


def fpr(real_mask, pred_mask) -> float:
    """The reference's FP / (FP + TN) with FP = (real==1 & pred==0)."""
    _, miss, _, tn = _counts(real_mask, pred_mask)
    return float(miss / (miss + tn + 1e-6))


def recall_correct(real_mask, pred_mask) -> float:
    """Textbook recall: TP / (TP + FN), FN = (real==1 & pred==0)."""
    tp, miss, _, _ = _counts(real_mask, pred_mask)
    return float(tp / (tp + miss + 1e-6))


def fpr_correct(real_mask, pred_mask) -> float:
    """Textbook FPR: FP / (FP + TN), FP = (real==0 & pred==1)."""
    _, _, false_alarm, tn = _counts(real_mask, pred_mask)
    return float(false_alarm / (false_alarm + tn + 1e-6))


def roc_curve(labels, scores):
    """ROC curve over flattened pixel scores: (fpr, tpr, thresholds) with
    sklearn's conventions, thresholds descending and the curve anchored at
    (0, 0)."""
    labels = np.asarray(labels).reshape(-1).astype(bool)
    scores = np.asarray(scores).reshape(-1).astype(np.float64)
    order = np.argsort(-scores, kind="stable")
    scores = scores[order]
    labels = labels[order]
    distinct = np.where(np.diff(scores))[0]     # where the threshold changes
    idx = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels)[idx]
    fps = 1 + idx - tps
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thresholds = np.r_[np.inf, scores[idx]]
    p = max(tps[-1], 1e-12)
    n = max(fps[-1], 1e-12)
    return fps / n, tps / p, thresholds


# numpy < 2 names the trapezoidal rule `trapz`
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def auc(x, y) -> float:
    """Trapezoidal area under y(x)."""
    return float(_trapezoid(y, x))


def roc_auc_score(labels, scores) -> float:
    f, t, _ = roc_curve(labels, scores)
    return auc(f, t)


def ssim(real: np.ndarray, recon: np.ndarray, data_range: float = 2.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03,
         channel_axis=None) -> float:
    """Structural similarity over all axes of the arrays (skimage's default
    algorithm), or the mean over `channel_axis`."""
    real = np.asarray(real, np.float64)
    recon = np.asarray(recon, np.float64)
    if channel_axis is not None:
        return float(np.mean([
            ssim(np.take(real, c, axis=channel_axis),
                 np.take(recon, c, axis=channel_axis), data_range, win_size,
                 k1, k2)
            for c in range(real.shape[channel_axis])]))
    np_win = win_size ** real.ndim
    cov_norm = np_win / (np_win - 1)
    filt = lambda a: uniform_filter(a, size=win_size)
    ux, uy = filt(real), filt(recon)
    uxx, uyy, uxy = filt(real * real), filt(recon * recon), filt(real * recon)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = (((2 * ux * uy + c1) * (2 * vxy + c2))
         / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    pad = (win_size - 1) // 2
    return float(s[tuple(slice(pad, dim - pad) for dim in s.shape)].mean())


def psnr(recon, real) -> float:
    """PSNR with the reference's max(real) peak convention."""
    real = np.asarray(real, np.float64)
    recon = np.asarray(recon, np.float64)
    mse = np.mean((real - recon) ** 2)
    return float(20 * np.log10(real.max() / np.sqrt(mse)))


def batched_roc_auc(labels: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Per-slice ROC-AUC over a (S, ...) stack via the Mann-Whitney rank sum
    with average ranks for ties; all-negative/all-positive masks give 0."""
    s = scores.reshape(scores.shape[0], -1).astype(np.float64)
    lab = labels.reshape(labels.shape[0], -1).astype(bool)
    ranks = rankdata(s, method="average", axis=1)
    p = lab.sum(axis=1).astype(np.float64)
    n = lab.shape[1] - p
    rank_sum = np.where(lab, ranks, 0.0).sum(axis=1)
    return ((rank_sum - p * (p + 1) / 2)
            / (np.maximum(p, 1e-12) * np.maximum(n, 1e-12)))


def batched_ssim(real: np.ndarray, recon: np.ndarray,
                 data_range: float = 2.0, win_size: int = 7,
                 k1: float = 0.01, k2: float = 0.03) -> np.ndarray:
    """Per-slice SSIM over (S, H, W, C) stacks (mean over channels)."""
    real = np.asarray(real, np.float64)
    recon = np.asarray(recon, np.float64)
    np_win = win_size ** 2
    cov_norm = np_win / (np_win - 1)
    filt = lambda a: uniform_filter(a, size=(1, win_size, win_size, 1))
    ux, uy = filt(real), filt(recon)
    uxx, uyy, uxy = filt(real * real), filt(recon * recon), filt(real * recon)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return s[:, pad:s.shape[1] - pad, pad:s.shape[2] - pad, :].mean(
        axis=(1, 2, 3))


def batched_anomaly_metrics(real: np.ndarray, recon: np.ndarray,
                            mask: np.ndarray) -> dict:
    """All seven per-slice detection metrics; {name: (S,) float64 array}."""
    real = np.asarray(real, np.float64)
    recon = np.asarray(recon, np.float64)
    mask = np.asarray(mask, np.float64)
    axes = tuple(range(1, real.ndim))
    mse_raw = (real - recon) ** 2
    pred = (mse_raw > 0.5).astype(np.float64)
    m1, p1 = mask == 1, pred == 1
    m0, p0 = mask == 0, pred == 0
    tp = (m1 & p1).sum(axis=axes).astype(np.float64)
    inter = (pred * mask).sum(axis=axes)
    union = pred.sum(axis=axes) + mask.sum(axis=axes)
    return {
        "auc": batched_roc_auc(mask.astype(np.uint8), mse_raw),
        "dice": (2.0 * inter + 1e-6) / (union + 1e-6),
        "ssim": batched_ssim(real, recon),
        "iou": (m1 & p1).sum(axis=axes) / ((m1 | p1).sum(axis=axes) + 1e-8),
        "precision": tp / (tp + (m1 & p0).sum(axis=axes) + 1e-6),
        "recall": tp / (tp + (m0 & p1).sum(axis=axes) + 1e-6),
        "fpr": ((m1 & p0).sum(axis=axes)
                / ((m1 & p0).sum(axis=axes) + (m0 & p0).sum(axis=axes) + 1e-6)),
    }
