"""Synthetic MRI-like slices from a seed: healthy phantoms for training,
anomalous volumes of 4 slices with a bump lesion and its mask for
detection.

A frozen copy of `anoddpm_torch/data/synthetic.py`'s generators (`_phantom`,
`_lesion` and the volume of `SyntheticAnomalyDataset`, lesion kind "bump")
as the benchmark was defined; each slice's numpy generator is seeded from
the run's seed instead of the dataset index.  Images lie in [-1, 1].
"""

from __future__ import annotations

import numpy as np

from .seeds import sub_seed


def _phantom(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy = h / 2 + rng.uniform(-h * 0.03, h * 0.03)
    cx = w / 2 + rng.uniform(-w * 0.03, w * 0.03)
    ry, rx = h * rng.uniform(0.3, 0.38), w * rng.uniform(0.25, 0.33)
    ellipse = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1.0
    tex = np.zeros((h, w), np.float32)
    for _ in range(6):
        fy, fx = rng.uniform(1, 4, size=2)
        ph = rng.uniform(0, 2 * np.pi, size=2)
        tex += (np.cos(2 * np.pi * fy * yy / h + ph[0])
                * np.cos(2 * np.pi * fx * xx / w + ph[1]))
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-6)
    img = np.where(ellipse, 0.35 + 0.45 * tex, 0.0).astype(np.float32)
    rv = min(ry, rx) * 0.3
    vent = (((yy - cy) / rv) ** 2 + ((xx - cx) / rv) ** 2) < 1.0
    return np.where(vent, img * 0.4, img)


def _lesion(rng: np.random.Generator, h: int, w: int):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = rng.uniform(h * 0.3, h * 0.7), rng.uniform(w * 0.3, w * 0.7)
    r = rng.uniform(min(h, w) * 0.06, min(h, w) * 0.14)
    d2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / (r * r)
    return np.exp(-2.0 * d2).astype(np.float32), (d2 < 1.0).astype(np.float32)


def healthy(seed: int, index: int, h: int, w: int) -> np.ndarray:
    """One healthy slice (H, W) float32 in [-1, 1]."""
    rng = np.random.default_rng(sub_seed(seed, "healthy", index))
    return ((_phantom(rng, h, w) - 0.5) / 0.5).astype(np.float32)


def anomalous_volume(seed: int, index: int, h: int, w: int, slices: int = 4):
    """(images, masks), each (slices, H, W, 1) float32."""
    imgs, masks = [], []
    for s in range(slices):
        rng = np.random.default_rng(sub_seed(seed, "volume", index, s))
        img = _phantom(rng, h, w)
        bump, mask = _lesion(rng, h, w)
        img = np.clip(img + 0.5 * bump * (img > 0.05), 0, 1)
        imgs.append(((img - 0.5) / 0.5)[..., None])
        masks.append(mask[..., None])
    return np.stack(imgs).astype(np.float32), np.stack(masks).astype(np.float32)
