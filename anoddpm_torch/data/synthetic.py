"""Synthetic MRI-like phantoms with lesions and ground-truth masks.

Own copy of the anomalous half of `anoddpm_tpu/data/synthetic.py` (numpy
only): smooth elliptical "brain" phantoms with low-frequency texture, each
with a localised lesion ("bump") or a diffuse, intensity-matched,
irregular one ("diffuse"), plus its mask.  Samples are deterministic per
index, so the port and the JAX package see the same volumes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _phantom(rng: np.random.Generator, size: Tuple[int, int]) -> np.ndarray:
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h / 2 + rng.uniform(-h * 0.03, h * 0.03), w / 2 + rng.uniform(-w * 0.03, w * 0.03)
    ry, rx = h * rng.uniform(0.3, 0.38), w * rng.uniform(0.25, 0.33)
    ellipse = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1.0
    # low-frequency texture from a few random cosines
    tex = np.zeros((h, w), np.float32)
    for _ in range(6):
        fy, fx = rng.uniform(1, 4, size=2)
        ph = rng.uniform(0, 2 * np.pi, size=2)
        tex += np.cos(2 * np.pi * fy * yy / h + ph[0]) * np.cos(2 * np.pi * fx * xx / w + ph[1])
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-6)
    img = np.where(ellipse, 0.35 + 0.45 * tex, 0.0).astype(np.float32)
    # inner "ventricle" darker region
    rv = min(ry, rx) * 0.3
    vent = (((yy - cy) / rv) ** 2 + ((xx - cx) / rv) ** 2) < 1.0
    img = np.where(vent, img * 0.4, img)
    return img


def _lesion(rng: np.random.Generator, size: Tuple[int, int]):
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy = rng.uniform(h * 0.3, h * 0.7)
    cx = rng.uniform(w * 0.3, w * 0.7)
    r = rng.uniform(min(h, w) * 0.06, min(h, w) * 0.14)
    d2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / (r * r)
    mask = d2 < 1.0
    bump = np.exp(-2.0 * d2).astype(np.float32)
    return bump, mask.astype(np.float32)


def _diffuse_lesion(rng: np.random.Generator, size: Tuple[int, int],
                    img: np.ndarray, severity: float = 1.0):
    """Harder lesion family: low-frequency, intensity-matched and
    irregular, like the diffuse real tumours the paper evaluates on,
    unlike the bright `_lesion` bumps.

    - Irregular boundary: star-shaped domain r(theta) = r0 * (1 + sum_k
      a_k cos(k theta + phi_k)), k in 2..5.
    - Diffuse margin: a sigmoid falloff over ~35% of the radius.
    - Intensity-matched: pixel values are pulled toward a target inside
      the tissue's own intensity envelope (tissue mean +- offset), with
      low-frequency internal texture.

    `severity` scales the local contrast (the |offset| draw and the blend
    strength floor); the default keeps the lesion above chance for a
    model trained on healthy phantoms (same draws as the JAX package).

    Returns (lesioned_img in [0,1], mask): the blend happens here (it
    needs the tissue statistics), unlike `_lesion`, which returns a bump
    for the caller to add.
    """
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tissue = img > 0.05
    cy = rng.uniform(h * 0.32, h * 0.68)
    cx = rng.uniform(w * 0.32, w * 0.68)
    r0 = rng.uniform(min(h, w) * 0.08, min(h, w) * 0.16)
    theta = np.arctan2(yy - cy, xx - cx)
    r_theta = np.full((h, w), r0, np.float32)
    for k in range(2, 6):
        a_k = rng.uniform(0.0, 0.35 / (k - 1))
        phi = rng.uniform(0, 2 * np.pi)
        r_theta *= 1.0 + a_k * np.cos(k * theta + phi)
    d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    # smooth margin: 1 inside, ->0 over ~0.35 r0 around the boundary
    falloff = 1.0 / (1.0 + np.exp((d - r_theta) / (0.18 * r0)))
    falloff = (falloff * tissue).astype(np.float32)
    mask = (falloff > 0.5).astype(np.float32)

    # intensity target inside the tissue's own global envelope, with a
    # severity-scaled floor on the local offset (see docstring)
    t_mean = float(img[tissue].mean()) if tissue.any() else 0.5
    lo, hi = 0.12 * severity, min(0.28 * severity, 0.45)
    offset = rng.choice([-1.0, 1.0]) * rng.uniform(lo, max(hi, lo + 0.01))
    target = np.clip(t_mean + offset, 0.1, 0.9)
    tex = np.zeros((h, w), np.float32)
    for _ in range(3):
        fy, fx = rng.uniform(0.5, 2.0, size=2)
        ph = rng.uniform(0, 2 * np.pi, size=2)
        tex += np.cos(2 * np.pi * fy * yy / h + ph[0]) \
            * np.cos(2 * np.pi * fx * xx / w + ph[1])
    tex *= 0.08 / 3.0
    s_lo = min(0.55 * severity, 0.9)
    s_hi = min(0.85 * severity, 0.98)
    strength = rng.uniform(s_lo, max(s_hi, s_lo + 0.01))
    lesioned = img + strength * falloff * (target + tex - img)
    return np.clip(lesioned, 0.0, 1.0).astype(np.float32), mask


class SyntheticAnomalyDataset:
    """Anomalous phantoms + ground-truth lesion masks; sample contract of
    AnomalousMRIDataset in iterateKnown_restricted mode (dataset.py:731-754):
    {"image": SxHxWx1, "mask": SxHxWx1, "filenames", "slices"}."""

    def __init__(self, img_size=(64, 64), length: int = 22,
                 slices_per_volume: int = 4, seed: int = 1,
                 lesion_kind: str = "bump", lesion_severity: float = 1.0):
        if lesion_kind not in ("bump", "diffuse"):
            raise ValueError(f"unknown lesion_kind {lesion_kind!r} "
                             "(expected 'bump' or 'diffuse')")
        self.img_size = tuple(img_size)
        self.length = length
        self.slices_per_volume = slices_per_volume
        self.seed = seed
        self.lesion_kind = lesion_kind
        self.lesion_severity = float(lesion_severity)

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        imgs, masks = [], []
        for s in range(self.slices_per_volume):
            rng = np.random.default_rng(self.seed * 999983 + idx * 131 + s)
            img = _phantom(rng, self.img_size)
            if self.lesion_kind == "diffuse":
                img, mask = _diffuse_lesion(rng, self.img_size, img,
                                            severity=self.lesion_severity)
            else:
                bump, mask = _lesion(rng, self.img_size)
                img = np.clip(img + 0.5 * bump * (img > 0.05), 0, 1)
            img = (img - 0.5) / 0.5
            imgs.append(img[..., None])
            masks.append(mask[..., None])
        return {
            "image": np.stack(imgs).astype(np.float32),
            "mask": np.stack(masks).astype(np.float32),
            "filenames": f"synthetic-anomalous-{idx:05d}",
            "slices": np.arange(self.slices_per_volume),
        }
