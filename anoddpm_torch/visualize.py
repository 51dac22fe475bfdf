"""Output rendering: image grids, heatmap figures, training snapshots and
diffusion videos, from NHWC float arrays in [-1, 1].

Counterpart of `anoddpm_tpu/visualize.py`, with the same artifact names
and panel layouts.  Grid PNGs are written by the small encoder below
(numpy, `zlib`, `struct`: 8-bit grey or RGB, the title as a PNG `tEXt`
chunk), so that grids and heatmaps need no plotting package; its
counterpart `decode_png` reads 8-bit PNGs for the texture datasets, so
that they need no image package either.  `save_video`
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


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _unfilter(kind: int, row: bytearray, prior: bytes, bpp: int) -> None:
    """Undo one scanline's PNG filter in place (None, Sub, Up, Average,
    Paeth), `prior` the previous scanline, already unfiltered."""
    n = len(row)
    if kind == 1:
        for i in range(bpp, n):
            row[i] = (row[i] + row[i - bpp]) & 0xFF
    elif kind == 2:
        for i in range(n):
            row[i] = (row[i] + prior[i]) & 0xFF
    elif kind == 3:
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF
    elif kind == 4:
        for i in range(n):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
            row[i] = (row[i] + pred) & 0xFF
    elif kind != 0:
        raise ValueError(f"decode_png: unknown filter type {kind}")


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced PNG as uint8: (H, W) grey, (H, W, 2) grey
    and alpha, (H, W, 3) RGB or (H, W, 4) RGBA.  Raises on other formats."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("decode_png: not a PNG")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("decode_png: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f"decode_png: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}: only 8-bit grey, grey+alpha, "
                         "RGB and RGBA without interlacing are read")
    bpp = _PNG_CHANNELS[color]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"decode_png: {len(raw)} bytes of image data for "
                         f"{h} rows of {stride}")
    out = np.empty((h, stride), np.uint8)
    prior = bytes(stride)
    for y in range(h):
        start = y * (stride + 1)
        row = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter(raw[start], row, prior, bpp)
        out[y] = np.frombuffer(bytes(row), np.uint8)
        prior = row
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


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
