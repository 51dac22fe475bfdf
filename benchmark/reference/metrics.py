"""The per-slice anomaly metrics, numpy float64.

A frozen copy of `anoddpm_torch/metrics.py`'s `batched_anomaly_metrics`
(with `batched_roc_auc` and `batched_ssim`) as the benchmark was defined:
AUC of the raw square-error map by the rank-sum identity, the other
metrics on the map thresholded at 0.5, with the reference's conventions.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter
from scipy.stats import rankdata

NAMES = ("dice", "ssim", "iou", "precision", "recall", "fpr", "auc")


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> np.ndarray:
    s = scores.reshape(scores.shape[0], -1).astype(np.float64)
    lab = labels.reshape(labels.shape[0], -1).astype(bool)
    ranks = rankdata(s, method="average", axis=1)
    p = lab.sum(axis=1).astype(np.float64)
    n = lab.shape[1] - p
    rank_sum = np.where(lab, ranks, 0.0).sum(axis=1)
    return ((rank_sum - p * (p + 1) / 2)
            / (np.maximum(p, 1e-12) * np.maximum(n, 1e-12)))


def ssim(real: np.ndarray, recon: np.ndarray, data_range: float = 2.0,
         win: int = 7, k1: float = 0.01, k2: float = 0.03) -> np.ndarray:
    cov_norm = win ** 2 / (win ** 2 - 1)
    filt = lambda a: uniform_filter(a, size=(1, win, win, 1))
    ux, uy = filt(real), filt(recon)
    vx = cov_norm * (filt(real * real) - ux * ux)
    vy = cov_norm * (filt(recon * recon) - uy * uy)
    vxy = cov_norm * (filt(real * recon) - ux * uy)
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    pad = (win - 1) // 2
    return s[:, pad:s.shape[1] - pad, pad:s.shape[2] - pad, :].mean(axis=(1, 2, 3))


def anomaly_metrics(real, recon, mask) -> dict:
    """{name: (S,) float64} over (S, H, W, C) stacks."""
    real = np.asarray(real, np.float64)
    recon = np.asarray(recon, np.float64)
    mask = np.asarray(mask, np.float64)
    axes = tuple(range(1, real.ndim))
    err = (real - recon) ** 2
    pred = (err > 0.5).astype(np.float64)
    m1, p1, m0, p0 = mask == 1, pred == 1, mask == 0, pred == 0
    tp = (m1 & p1).sum(axis=axes).astype(np.float64)
    miss = (m1 & p0).sum(axis=axes)
    return {
        "auc": roc_auc(mask.astype(np.uint8), err),
        "dice": (2.0 * (pred * mask).sum(axis=axes) + 1e-6)
                / (pred.sum(axis=axes) + mask.sum(axis=axes) + 1e-6),
        "ssim": ssim(real, recon),
        "iou": tp / ((m1 | p1).sum(axis=axes) + 1e-8),
        "precision": tp / (tp + miss + 1e-6),
        "recall": tp / (tp + (m0 & p1).sum(axis=axes) + 1e-6),
        "fpr": miss / (miss + (m0 & p0).sum(axis=axes) + 1e-6),
    }
