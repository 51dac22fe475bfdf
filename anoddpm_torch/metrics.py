"""Per-slice anomaly-segmentation metrics over (S, H, W, C) numpy stacks,
and the PSNR of the test-set suite.

Own copy of what `anoddpm_tpu/metrics.py:batched_anomaly_metrics` and
`psnr` need: AUC on the raw square-error map (rank-sum identity, equal to
the trapezoidal ROC integral), SSIM with skimage's default algorithm (7x7
uniform window, K1=.01, K2=.03, data range 2, border crop), and the
thresholded metrics at 0.5, keeping the reference's swapped recall/FPR
conventions.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter
from scipy.stats import rankdata


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
