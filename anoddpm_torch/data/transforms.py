"""Host-side image transforms of the MRI pipelines, numpy only.

Own copy of `anoddpm_tpu/data/transforms.py`, which calls OpenCV for three
things; here they are written out so that the port needs no `cv2`:

- `resize_bilinear`: `cv2.resize(..., INTER_LINEAR)` on float32: half-pixel
  centres, no antialiasing, the horizontal pass first.  Agrees with OpenCV
  within a few fp32 ulps (OpenCV's SIMD sums in another order).
- `warp_affine_linear`: `cv2.warpAffine(..., INTER_LINEAR, BORDER_CONSTANT)`
  on float32, as OpenCV 5 computes it: the inverse map in double rounded to
  fp32, source coordinates x * M0 + (y * M1 + M2) with one fused
  multiply-add, bilinear weights from the coordinates' fractions, and
  out-of-image taps read as 0.
- `fill_ellipse`: `cv2.ellipse(..., thickness=-1)`: the ellipse as OpenCV's
  polygon of rounded fixed-point vertices (its integer-degree sine table),
  filled by its convex-polygon scan and outlined by its 8-connected line
  walk.  Agrees with OpenCV on all but a few boundary pixels.

All functions take and return float32 H x W (or H x W x C) arrays;
`normalize_unit` maps [0, 1] intensities to [-1, 1] (Normalize(.5, .5)).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def center_crop(img: np.ndarray, size) -> np.ndarray:
    """CenterCrop with zero padding when the image is smaller (torchvision
    semantics)."""
    if isinstance(size, int):
        size = (size, size)
    th, tw = size
    h, w = img.shape[:2]
    pad_h = max(th - h, 0)
    pad_w = max(tw - w, 0)
    if pad_h or pad_w:
        pads = [(pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2)]
        pads += [(0, 0)] * (img.ndim - 2)
        img = np.pad(img, pads)
        h, w = img.shape[:2]
    y = (h - th) // 2
    x = (w - tw) // 2
    return img[y:y + th, x:x + tw]


def _linear_taps(src: int, dst: int):
    """OpenCV's INTER_LINEAR taps along one axis: the two source indices
    and their fp32 weights for each output index, clamped at the edges."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    edge = (s < 0) | (s >= src - 1)
    f[edge] = 0.0
    s = np.clip(s, 0, src - 1)
    return s, np.minimum(s + 1, src - 1), np.float32(1.0) - f, f


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """Bilinear resize to `size` = (H, W) (or an int for a square).  Like
    cv2.resize, an (H, W, 1) image comes back as (H', W')."""
    if isinstance(size, int):
        size = (size, size)
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(w, size[1])
    y0, y1, b0, b1 = _linear_taps(h, size[0])
    col = (slice(None),) + (None,) * (img.ndim - 2)
    row = (slice(None), None) + (None,) * (img.ndim - 2)
    rows = img[:, x0] * a0[col] + img[:, x1] * a1[col]
    return rows[y0] * b0[row] + rows[y1] * b1[row]


def rotation_matrix(center, angle: float, scale: float = 1.0) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64, `angle` in degrees
    counter-clockwise about `center` = (x, y), taken as fp32 as OpenCV's
    Point2f takes it."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray):
    """The inverse of a 2 x 3 affine map, in double as OpenCV inverts it."""
    m0, m1, m2, m3, m4, m5 = (float(v) for v in np.asarray(m).ravel())
    d = m0 * m4 - m1 * m3
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m4 * d, m0 * d
    m0, m1, m3, m4 = a11, -m1 * d, -m3 * d, a22
    return m0, m1, -m0 * m2 - m1 * m5, m3, m4, -m3 * m2 - m4 * m5


def _fma(a, b, c) -> np.ndarray:
    """fp32 a * b + c with one rounding (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def warp_affine_linear(img: np.ndarray, m: np.ndarray, dsize) -> np.ndarray:
    """Bilinear affine warp of a float32 (H, W) image by the forward map
    `m` (2 x 3) into dsize = (W', H'), 0 outside the source."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    inv = np.array(_invert_affine(m), np.float32)
    xs = np.arange(dsize[0], dtype=np.float32)[None]
    ys = np.arange(dsize[1], dtype=np.float32)[:, None]
    sx = _fma(xs, inv[0], ys * inv[1] + inv[2])
    sy = _fma(xs, inv[3], ys * inv[4] + inv[5])
    ix, iy = np.floor(sx), np.floor(sy)
    alpha, beta = sx - ix, sy - iy
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        return np.where(inside, img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)],
                        np.float32(0.0))

    v00, v01, v10, v11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = _fma(alpha, v01 - v00, v00)
    bottom = _fma(alpha, v11 - v10, v10)
    return _fma(beta, bottom - top, top)


def random_affine(img: np.ndarray, rng: np.random.Generator,
                  degrees: float = 3.0,
                  translate: Tuple[float, float] = (0.02, 0.09)) -> np.ndarray:
    """RandomAffine(degrees, translate) a la torchvision: rotation about the
    centre plus a whole-pixel translation, drawn from `rng` in the JAX
    package's order (angle, then x, then y shift)."""
    h, w = img.shape[:2]
    angle = rng.uniform(-degrees, degrees)
    max_dx = translate[0] * w
    max_dy = translate[1] * h
    tx = round(rng.uniform(-max_dx, max_dx))
    ty = round(rng.uniform(-max_dy, max_dy))
    m = rotation_matrix((w / 2, h / 2), angle, 1.0)
    m[0, 2] += tx
    m[1, 2] += ty
    return warp_affine_linear(img, m, (w, h))


def normalize_unit(img: np.ndarray) -> np.ndarray:
    """Normalize(0.5, 0.5): x -> (x - .5) / .5, i.e. [0,1] -> [-1,1]."""
    return (img.astype(np.float32) - 0.5) / 0.5


def clip_normalise_volume(volume: np.ndarray) -> np.ndarray:
    """The reference's volume intensity normalisation: clip to
    [mean - std, mean + 2*std] then divide by the range."""
    mean = np.mean(volume)
    std = np.std(volume)
    lo, hi = mean - 1 * std, mean + 2 * std
    out = np.clip(volume, lo, hi)
    return out / (hi - lo)


def mri_train_transform(img: np.ndarray, img_size, rng: np.random.Generator,
                        random_affine_aug: bool = True) -> np.ndarray:
    """Healthy-MRI training pipeline: RandomAffine(3, (.02,.09)) ->
    CenterCrop(235) -> Resize(img_size) -> Normalize(.5,.5).  Returns
    H x W x 1."""
    if random_affine_aug:
        img = random_affine(img, rng)
    img = center_crop(img, 235)
    img = resize_bilinear(img, img_size)
    img = normalize_unit(img)
    return img[..., None]


def anomalous_transform(img: np.ndarray, img_size) -> np.ndarray:
    """Anomalous-MRI pipeline: CenterCrop((175,240)) -> Resize ->
    Normalize(.5,.5).  Returns H x W x 1."""
    img = center_crop(img, (175, 240))
    img = resize_bilinear(img, img_size)
    img = normalize_unit(img)
    return img[..., None]


# --- the filled ellipse ------------------------------------------------------

_SHIFT = 16                 # OpenCV's XY_SHIFT: vertices in 16.16 fixed point
_ONE = 1 << _SHIFT
# OpenCV's sine table: sin(i degrees) for i in 0..450, as its source prints
# them, to 7 decimals.
_SIN = np.array([np.float32(round(math.sin(math.radians(i)), 7))
                 for i in range(451)], np.float32)


def _ellipse_polygon(center, axes, angle: float):
    """The fixed-point vertices of cv2.ellipse2Poly for a whole ellipse:
    every `delta` degrees (by the ellipse's size), rotated by the angle
    rounded to whole degrees, without repeats."""
    ang = int(round(angle)) % 360
    a, b = abs(int(axes[0])) << _SHIFT, abs(int(axes[1])) << _SHIFT
    size = (max(a, b) + (_ONE >> 1)) >> _SHIFT
    delta = 90 if size < 3 else 30 if size < 10 else 18 if size < 15 else 5
    cos_a, sin_a = float(_SIN[450 - ang]), float(_SIN[ang])
    cx, cy = int(center[0]) << _SHIFT, int(center[1]) << _SHIFT
    out, prev = [], None
    for i in range(0, 360 + delta, delta):
        k = min(i, 360)
        x, y = a * float(_SIN[450 - k]), b * float(_SIN[k])
        px = cx + x * cos_a - y * sin_a
        py = cy + x * sin_a + y * cos_a
        vx = int(np.rint(px / _ONE)) << _SHIFT
        vy = int(np.rint(py / _ONE)) << _SHIFT
        pt = (vx + int(np.rint(px - vx)), vy + int(np.rint(py - vy)))
        if pt != prev:
            out.append(pt)
            prev = pt
    return out


def _trunc_div(a: int, b: int) -> int:
    """C's integer division, which truncates toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_convex(mask: np.ndarray, v) -> None:
    """OpenCV's FillConvexPoly scan of fixed-point vertices `v`: two edges
    walked down from the top vertex, one span per row."""
    h, w = mask.shape
    n = len(v)
    half = _ONE >> 1
    ys = [p[1] for p in v]
    xs = [p[0] for p in v]
    top = int(np.argmin(ys))
    y, ymax = (min(ys) + half) >> _SHIFT, (max(ys) + half) >> _SHIFT
    if (n < 3 or (max(xs) + half) >> _SHIFT < 0 or ymax < 0
            or (min(xs) + half) >> _SHIFT >= w or y >= h):
        return
    ymax = min(ymax, h - 1)
    edges = n
    walk = [{"idx": top, "di": 1, "x": -_ONE, "dx": 0, "ye": y},
            {"idx": top, "di": n - 1, "x": -_ONE, "dx": 0, "ye": y}]
    while True:
        for e in walk:
            if y < e["ye"]:
                continue
            idx0, idx = e["idx"], (e["idx"] + e["di"]) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + half) >> _SHIFT
                if ty > y:
                    x0, x1 = v[idx0][0], v[idx][0]
                    e.update(ye=ty, x=x0, idx=idx,
                             dx=_trunc_div((x1 - x0) * 2 + (ty - y), 2 * (ty - y)))
                    break
                idx0, idx = idx, (idx + e["di"]) % n
        if edges < 0:
            return
        if y >= 0:
            left, right = sorted(walk, key=lambda e: e["x"])
            x1 = (left["x"] + half) >> _SHIFT
            x2 = (right["x"] + half) >> _SHIFT
            if x2 >= 0 and x1 < w:
                mask[y, max(x1, 0):min(x2, w - 1) + 1] = 1
        for e in walk:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            return


def _line(mask: np.ndarray, p1, p2) -> None:
    """The 8-connected fixed-point line from p1 to p2 that OpenCV draws
    round a filled polygon: the end point rounded to its pixel, then one
    pixel per step along the major axis from p1's."""
    h, w = mask.shape
    half = _ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            mask[y, x] = 1

    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    steep = abs(dy) >= abs(dx)
    if steep:
        if dy < 0:
            x1, x2, y1, y2, dx = x2, x1, y2, y1, -dx
        step = _trunc_div(dx << _SHIFT, abs(dy) | 1)
        count = ((y2 + half) >> _SHIFT) - (y1 >> _SHIFT)
    else:
        if dx < 0:
            x1, x2, y1, y2, dy = x2, x1, y2, y1, -dy
        step = _trunc_div(dy << _SHIFT, abs(dx) | 1)
        count = ((x2 + half) >> _SHIFT) - (x1 >> _SHIFT)
    put((x2 + half) >> _SHIFT, (y2 + half) >> _SHIFT)
    x1 += half
    y1 += half
    if steep:
        y1 >>= _SHIFT
    else:
        x1 >>= _SHIFT
    for _ in range(count):
        put(x1 >> _SHIFT, y1) if steep else put(x1, y1 >> _SHIFT)
        if steep:
            x1, y1 = x1 + step, y1 + 1
        else:
            x1, y1 = x1 + 1, y1 + step


def fill_ellipse(shape_hw, center, axes, angle: float) -> np.ndarray:
    """A uint8 (H, W) mask, 1 inside the filled ellipse at `center` = (x, y)
    with half-axes `axes` = (a, b) in whole pixels, rotated by `angle`
    degrees: cv2.ellipse(mask, center, axes, angle, 0, 360, 1, -1)."""
    mask = np.zeros(tuple(shape_hw), np.uint8)
    v = _ellipse_polygon(center, axes, angle)
    if len(v) == 1:
        v = [v[0], v[0]]
    _fill_convex(mask, v)
    prev = v[-1]
    for p in v:
        _line(mask, prev, p)
        prev = p
    return mask
