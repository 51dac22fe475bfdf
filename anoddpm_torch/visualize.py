"""Output rendering: image grids, heatmap figures, training snapshots and
diffusion videos, from NHWC float arrays in [-1, 1].

Counterpart of `anoddpm_tpu/visualize.py`, with the same artifact names
and panel layouts.  Grid PNGs are written by the small encoder below
(numpy, `zlib`, `struct`: 8-bit grey or RGB, the title as a PNG `tEXt`
chunk), so that grids and heatmaps need no plotting package.  `save_video`
imports `imageio` when it is called: an mp4 where imageio has a writer for
it, else a GIF beside the asked-for path.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return np.clip((np.asarray(img, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def gridify_output(images: np.ndarray, row_size: int = -1,
                   pad: int = 2) -> np.ndarray:
    """Tile an (N, H, W, C) stack into one uint8 grid image, `row_size`
    images per row, `pad` black pixels between and around them; (H', W')
    for one channel, else (H', W', C)."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[None]
    n, h, w, c = images.shape
    ncol = n if row_size in (-1, None) else min(row_size, n)
    nrow = math.ceil(n / ncol)
    grid = np.zeros((nrow * h + pad * (nrow + 1),
                     ncol * w + pad * (ncol + 1), c), np.uint8)
    u8 = to_uint8(images)
    for i in range(n):
        r, cidx = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + cidx * (w + pad)
        grid[y:y + h, x:x + w] = u8[i]
    return grid.squeeze(-1) if c == 1 else grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, title: Optional[str] = None) -> bytes:
    """An 8-bit PNG of a uint8 (H, W) grey or (H, W, 3) RGB image, rows
    unfiltered, with `title` as a tEXt chunk."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 2:
        color = 0
    elif image.ndim == 3 and image.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png: expected (H, W) or (H, W, 3) uint8, "
                         f"got {image.shape}")
    h, w = image.shape[:2]
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))]
    if title:
        out.append(_chunk(b"tEXt", b"Title\x00" + title.encode("latin-1", "replace")))
    out.append(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def save_grid_png(path: str, images: np.ndarray, row_size: int = -1,
                  title: Optional[str] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(gridify_output(images, row_size), title))


def save_video(path: str, frames: Sequence[np.ndarray], row_size: int = -1,
               fps: int = 20) -> str:
    """A grid video of `frames`, each a (B, H, W, C) array; returns the path
    written: `path`, or the same name with .gif when imageio has no writer
    for `path`'s format."""
    import imageio
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    grids = [gridify_output(f, row_size) for f in frames]
    try:
        imageio.mimsave(path, grids, fps=fps)
        return path
    except (ValueError, RuntimeError, OSError, ImportError):
        alt = os.path.splitext(path)[0] + ".gif"
        imageio.mimsave(alt, grids, duration=1.0 / fps)
        return alt


def heatmap_figure(real, recon, mask, path: str) -> None:
    """The reference's 5-panel heatmap: real, recon, square-error map,
    the map thresholded, ground truth."""
    real = np.asarray(real)
    recon = np.asarray(recon)
    mask = np.asarray(mask)
    mse = ((recon - real) ** 2 * 2) - 1
    mse_threshold = ((mse > 0).astype(np.float32) * 2) - 1
    panels = np.concatenate([real, recon, mse, mse_threshold, mask], axis=0)
    save_grid_png(path, panels, row_size=5)


def training_snapshot(path: str, x0, x_t, estimate, epoch: int,
                      row_size: int = 8) -> None:
    """Training image dump: real, noisy x_t, eps estimate, square error."""
    x0 = np.asarray(x0)[:row_size]
    x_t = np.asarray(x_t)[:row_size]
    est = np.asarray(estimate)[:row_size]
    err = (est - x_t) ** 2
    save_grid_png(path, np.concatenate([x0, x_t, est, err], axis=0), row_size,
                  title=f"real,noisy,noise prediction,mse-{epoch}epoch")


def sample_snapshot(path: str, x0, sample, pred_x0, epoch: int,
                    row_size: int = 8) -> None:
    """Real / sample / x0-prediction grid."""
    panels = np.concatenate([np.asarray(x0)[:row_size],
                             np.asarray(sample)[:row_size],
                             np.asarray(pred_x0)[:row_size]], axis=0)
    save_grid_png(path, panels, row_size,
                  title=f"real,sample,prediction x_0-{epoch}epoch")
