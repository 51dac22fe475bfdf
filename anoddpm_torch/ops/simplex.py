"""Multi-octave OpenSimplex noise: the hash path (kernel K1), the
table-exact path and the 2-D walk.

Counterpart of `anoddpm_tpu/ops/simplex.py`.  The branchless OpenSimplex
cell walk (8 region-gated cube corners plus 2 extra vertices) takes the
gradient of a lattice point from a murmur-style hash mod 24 (the hash path)
or from the reference's 3-level permutation gather (the table path, with
`perm_tables_from_seed`, the reference's LCG Fisher-Yates bit for bit, or
`perm_tables`, drawn on the device); the 2-D walk does the same with 4
vertices and 8 gradients.

`batched_fractal3_fixed_t` (octaves summed on a fixed z = t plane) launches
the CUDA kernel `csrc/simplex3_octave_field.cu` for tensors on the card
and computes the plain PyTorch version below for tensors on the CPU;
`batched_fractal3_fixed_t_params` does the same with (octaves,
persistence, frequency) read on the card, for the randParam noise; the
hash volume is K1 with one plane per z.  The table path and the 2-D walk
have no Hopper kernel yet: plain PyTorch on every device.

The plain version computes the uint32 hash in int64, masked to 32 bits
after every multiply and shift: PyTorch on the CPU has no `>>`, `%` or `//`
for `torch.uint32`.  Its float operations are the kernel's, in the same
order, each rounded, so the two agree to the last bit away from float ties.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import streams
from ..streams import Stream
from . import _build

STRETCH3 = -1.0 / 6.0  # (1/sqrt(3+1)-1)/3
SQUISH3 = 1.0 / 3.0    # (sqrt(3+1)-1)/3
NORM3 = 103.0

_MASK32 = 0xFFFFFFFF
_SQUISH3_F32 = float(np.float32(SQUISH3))
_STRETCH3_F32 = float(np.float32(STRETCH3))


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for int64 `a` in [0, 2^32) and a constant k < 2^32,
    split in 16-bit halves so no int64 product overflows."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash_grad_id(seed: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor,
                  zi: torch.Tensor) -> torch.Tensor:
    """Counter-based lattice hash -> gradient id in [0, 24), int64."""
    m = lambda v: v.to(torch.int64) & _MASK32
    h = (_mul32(m(xi), 0x8DA6B343) ^ _mul32(m(yi), 0xD8163841)
         ^ _mul32(m(zi), 0xCB1AB31F) ^ m(seed))
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h % 24


def _grad_components(gid: torch.Tensor):
    """The 24 OpenSimplex gradients are the sign patterns of permutations of
    (+-11, +-4, +-4): id r has magnitude 11 on axis r % 3 and signs r // 3."""
    m = gid % 3
    q = gid // 3
    one = torch.ones((), dtype=torch.float32, device=gid.device)
    sx = torch.where((q & 1) != 0, one, -one)
    sy = torch.where((q & 2) != 0, -one, one)
    sz = torch.where((q & 4) != 0, -one, one)
    mag = lambda axis: torch.where(m == axis, 11.0 * one, 4.0 * one)
    return sx * mag(0), sy * mag(1), sz * mag(2)


def _where(c, a, b):
    return torch.where(c, torch.as_tensor(a, device=c.device),
                       torch.as_tensor(b, device=c.device))


def _ext_offsets_region1(xins, yins, zins, in_sum):
    """Extra-vertex offsets for the (0,0,0)-tetrahedron region."""
    a_pt = torch.ones_like(xins, dtype=torch.int64)
    b_pt = torch.full_like(a_pt, 2)
    a_sc, b_sc = xins, yins
    cond_b = (xins >= yins) & (zins > yins)
    b_pt = _where(cond_b, 4, b_pt)
    b_sc = torch.where(cond_b, zins, b_sc)
    cond_a = (~cond_b) & (xins < yins) & (zins > xins)
    a_pt = _where(cond_a, 4, a_pt)
    a_sc = torch.where(cond_a, zins, a_sc)

    wins = 1.0 - in_sum
    case_a = (wins > a_sc) | (wins > b_sc)

    c_a = torch.where(b_sc > a_sc, b_pt, a_pt)
    cx, cy, cz = (c_a & 1) != 0, (c_a & 2) != 0, (c_a & 4) != 0
    ax0 = _where(cx, 1, -1)
    ax1 = _where(cx, 1, 0)
    ay0 = _where(cy, 1, _where(cx, -1, 0))
    ay1 = _where(cy, 1, _where(cx, 0, -1))
    az0 = _where(cz, 1, 0)
    az1 = _where(cz, 1, -1)

    c_b = a_pt | b_pt
    bx, by, bz = (c_b & 1) != 0, (c_b & 2) != 0, (c_b & 4) != 0
    pick = lambda a, b: torch.where(case_a, a, b)
    return (pick(ax0, _where(bx, 1, 0)), pick(ay0, _where(by, 1, 0)),
            pick(az0, _where(bz, 1, 0)), pick(ax1, _where(bx, 1, -1)),
            pick(ay1, _where(by, 1, -1)), pick(az1, _where(bz, 1, -1)))


def _ext_offsets_region2(xins, yins, zins, in_sum):
    """Extra-vertex offsets for the (1,1,1)-tetrahedron region."""
    a_pt = torch.full_like(xins, 6, dtype=torch.int64)
    b_pt = torch.full_like(a_pt, 5)
    a_sc, b_sc = xins, yins
    cond_b = (xins <= yins) & (zins < yins)
    b_pt = _where(cond_b, 3, b_pt)
    b_sc = torch.where(cond_b, zins, b_sc)
    cond_a = (~cond_b) & (xins > yins) & (zins < xins)
    a_pt = _where(cond_a, 3, a_pt)
    a_sc = torch.where(cond_a, zins, a_sc)

    wins = 3.0 - in_sum
    case_a = (wins < a_sc) | (wins < b_sc)

    c_a = torch.where(b_sc < a_sc, b_pt, a_pt)
    cx, cy, cz = (c_a & 1) != 0, (c_a & 2) != 0, (c_a & 4) != 0
    ax0 = _where(cx, 2, 0)
    ax1 = _where(cx, 1, 0)
    ay0 = _where(cy, _where(cx, 1, 2), 0)
    ay1 = _where(cy, _where(cx, 2, 1), 0)
    az0 = _where(cz, 1, 0)
    az1 = _where(cz, 2, 0)

    c_b = a_pt & b_pt
    bx, by, bz = (c_b & 1) != 0, (c_b & 2) != 0, (c_b & 4) != 0
    pick = lambda a, b: torch.where(case_a, a, b)
    return (pick(ax0, _where(bx, 1, 0)), pick(ay0, _where(by, 1, 0)),
            pick(az0, _where(bz, 1, 0)), pick(ax1, _where(bx, 2, 0)),
            pick(ay1, _where(by, 2, 0)), pick(az1, _where(bz, 2, 0)))


def _ext_offsets_region3(xins, yins, zins):
    """Extra-vertex offsets for the middle octahedron region."""
    p1 = xins + yins
    a_fs = p1 > 1.0
    a_sc = torch.where(a_fs, p1 - 1.0, 1.0 - p1)
    a_pt = _where(a_fs, 3, 4)

    p2 = xins + zins
    b_fs = p2 > 1.0
    b_sc = torch.where(b_fs, p2 - 1.0, 1.0 - p2)
    b_pt = _where(b_fs, 5, 2)

    p3 = yins + zins
    far = p3 > 1.0
    score = torch.where(far, p3 - 1.0, 1.0 - p3)
    repl_a = (a_sc <= b_sc) & (a_sc < score)
    repl_b = (~repl_a) & (a_sc > b_sc) & (b_sc < score)
    a_pt = torch.where(repl_a, _where(far, 6, 1), a_pt)
    a_fs = (repl_a & far) | (~repl_a & a_fs)
    b_pt = torch.where(repl_b, _where(far, 6, 1), b_pt)
    b_fs = (repl_b & far) | (~repl_b & b_fs)

    same_side = a_fs == b_fs

    # both on the (1,1,1) side: ext0 = (1,1,1), ext1 = 2 along the shared axis
    c_and = a_pt & b_pt
    fx1 = _where((c_and & 1) != 0, 2, 0)
    fy1 = _where(((c_and & 1) == 0) & ((c_and & 2) != 0), 2, 0)
    fz1 = _where(((c_and & 1) == 0) & ((c_and & 2) == 0), 2, 0)

    # both on the (0,0,0) side: ext0 = (0,0,0), ext1 = a permutation of
    # (1,1,-1) with -1 along the omitted axis
    c_or = a_pt | b_pt
    miss_x = (c_or & 1) == 0
    miss_y = (~miss_x) & ((c_or & 2) == 0)
    miss_z = (~miss_x) & (~miss_y)
    nx1, ny1, nz1 = _where(miss_x, -1, 1), _where(miss_y, -1, 1), _where(miss_z, -1, 1)

    sx0 = _where(a_fs, 1, 0)
    sx1 = torch.where(a_fs, fx1, nx1)
    sy1 = torch.where(a_fs, fy1, ny1)
    sz1 = torch.where(a_fs, fz1, nz1)

    # mixed sides: c1 = the further-side point, c2 = the closer-side point
    c1 = torch.where(a_fs, a_pt, b_pt)
    c2 = torch.where(a_fs, b_pt, a_pt)
    m1x = (c1 & 1) == 0
    m1y = (~m1x) & ((c1 & 2) == 0)
    m1z = (~m1x) & (~m1y)
    mx0, my0, mz0 = _where(m1x, -1, 1), _where(m1y, -1, 1), _where(m1z, -1, 1)
    mx1 = _where((c2 & 1) != 0, 2, 0)
    my1 = _where(((c2 & 1) == 0) & ((c2 & 2) != 0), 2, 0)
    mz1 = _where(((c2 & 1) == 0) & ((c2 & 2) == 0), 2, 0)

    pick = lambda s, m: torch.where(same_side, s, m)
    return (pick(sx0, mx0), pick(sx0, my0), pick(sx0, mz0),
            pick(sx1, mx1), pick(sy1, my1), pick(sz1, mz1))


# The 8 cube corners in lexicographic order.
_CORNERS = [(ox, oy, oz) for ox in (0, 1) for oy in (0, 1) for oz in (0, 1)]


def _skew(x, y, z):
    """Cell of the skewed lattice: floor coordinates, in-cell coordinates and
    their sum."""
    stretch = (x + y + z) * _STRETCH3_F32
    xs, ys, zs = x + stretch, y + stretch, z + stretch
    xsb_f, ysb_f, zsb_f = torch.floor(xs), torch.floor(ys), torch.floor(zs)
    xins, yins, zins = xs - xsb_f, ys - ysb_f, zs - zsb_f
    return (xsb_f, ysb_f, zsb_f), (xins, yins, zins), xins + yins + zins


def _opensimplex3_core(grad_id, x: torch.Tensor, y: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """The branchless cell walk over broadcast fp32 x/y/z, with
    `grad_id(xi, yi, zi)` giving the gradient id in [0, 24) of a lattice
    point (int64 coordinates)."""
    x, y, z = torch.broadcast_tensors(x, y, z)
    (xsb_f, ysb_f, zsb_f), (xins, yins, zins), in_sum = _skew(x, y, z)
    xsb, ysb, zsb = xsb_f.long(), ysb_f.long(), zsb_f.long()

    squish = (xsb_f + ysb_f + zsb_f) * _SQUISH3_F32
    dx0 = x - (xsb_f + squish)
    dy0 = y - (ysb_f + squish)
    dz0 = z - (zsb_f + squish)

    region1 = in_sum <= 1.0
    region2 = in_sum >= 2.0
    region3 = (~region1) & (~region2)

    def contrib(ox, oy, oz, active=None):
        if isinstance(ox, int):
            sq = float(np.float32(_SQUISH3_F32) * np.float32(ox + oy + oz))
        else:
            sq = (ox + oy + oz).to(torch.float32) * _SQUISH3_F32
        dx = dx0 - ox - sq
        dy = dy0 - oy - sq
        dz = dz0 - oz - sq
        attn = 2.0 - dx * dx - dy * dy - dz * dz
        gx, gy, gz = _grad_components(grad_id(xsb + ox, ysb + oy, zsb + oz))
        dot = gx * dx + gy * dy + gz * dz
        attn = torch.clamp(attn, min=0.0)
        if active is not None:
            attn = torch.where(active, attn, torch.zeros_like(attn))
        a2 = attn * attn
        return a2 * a2 * dot

    value = torch.zeros_like(x)
    for ox, oy, oz in _CORNERS:
        s = ox + oy + oz
        active = (region1 if s == 0 else region1 | region3 if s == 1
                  else region2 | region3 if s == 2 else region2)
        value = value + contrib(ox, oy, oz, active)

    e1 = _ext_offsets_region1(xins, yins, zins, in_sum)
    e2 = _ext_offsets_region2(xins, yins, zins, in_sum)
    e3 = _ext_offsets_region3(xins, yins, zins)
    sel = lambda i: torch.where(region1, e1[i], torch.where(region2, e2[i], e3[i]))
    value = value + contrib(sel(0), sel(1), sel(2))
    value = value + contrib(sel(3), sel(4), sel(5))
    return value / NORM3


def opensimplex3_hash(seed: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      z: torch.Tensor) -> torch.Tensor:
    """Gather-free OpenSimplex 3-D noise, elementwise over broadcast fp32
    x/y/z, with the gradient of each lattice point hashed from `seed`."""
    return _opensimplex3_core(
        lambda xi, yi, zi: _hash_grad_id(seed, xi, yi, zi), x, y, z)


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a (256,) table, or table[i][idx[i]] for (n, 256)
    tables and an index whose leading axis is the n fields."""
    if table.dim() == 1:
        return table[idx]
    n = table.shape[0]
    rows = torch.arange(n, device=idx.device).view((n,) + (1,) * (idx.dim() - 1))
    return table.reshape(-1)[rows * 256 + idx]


def opensimplex3(perm: torch.Tensor, grad_id3: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Table-exact OpenSimplex 3-D noise: the same cell walk with the
    gradient id from the reference's 3-level permutation gather,
    grad_id3[(perm[(perm[x & 255] + y) & 255] + z) & 255].  `perm` and
    `grad_id3` are int64 (256,) tables, or (n, 256) tables with one per
    field of the leading axis of x/y/z."""
    def grad_id(xi, yi, zi):
        i1 = _gather(perm, xi & 0xFF)
        i2 = _gather(perm, (i1 + yi) & 0xFF)
        return _gather(grad_id3, (i2 + zi) & 0xFF)
    return _opensimplex3_core(grad_id, x, y, z)


STRETCH2 = -0.211324865405187
SQUISH2 = 0.366025403784439
NORM2 = 47.0

# The 8 gradient directions of the 2-D walk (vertices of an octagon).
GRADIENTS2 = np.array([
    [5, 2], [2, 5], [-5, 2], [-2, 5],
    [5, -2], [2, -5], [-5, -2], [-2, -5],
], dtype=np.float32)

_INT64_MASK = (1 << 64) - 1


def _lcg_next(seed: int) -> int:
    """One step of the reference's 64-bit LCG, wrapped as a signed int64."""
    seed = (seed * 6364136223846793005 + 1442695040888963407) & _INT64_MASK
    if seed >= 1 << 63:
        seed -= 1 << 64
    return seed


def perm_tables_from_seed(seed: int = 3):
    """The reference's permutation table from its LCG Fisher-Yates init,
    bit for bit: (perm, perm % 24), int32 numpy (256,) arrays."""
    perm = np.zeros(256, dtype=np.int32)
    source = np.arange(256)
    for _ in range(3):
        seed = _lcg_next(seed)
    for i in range(255, -1, -1):
        seed = _lcg_next(seed)
        r = int((seed + 31) % (i + 1))  # Python % is already non-negative
        perm[i] = source[r]
        source[r] = source[i]
    return perm, (perm % 24).astype(np.int32)


def perm_tables(n: int, generator: Stream):
    """n independent permutations of 0..255 on the generator's device
    without a host sync: (perm, perm % 24), int64 (n, 256).  A JaxKey's
    are the JAX table path's, one `jax.random.permutation` per key of a
    split in n (`anoddpm_tpu/ops/simplex.py:111-114, 758-759`)."""
    perm = streams.of(generator).permutation(n, 256)
    return perm, perm % 24


def _grad_components2(gid: torch.Tensor):
    """The 8 octagon gradients by arithmetic: magnitudes (5, 2) for an even
    id, (2, 5) for an odd one, signs from bits 1 and 2."""
    one = torch.ones((), dtype=torch.float32, device=gid.device)
    even = (gid & 1) == 0
    gx = torch.where(even, 5.0 * one, 2.0 * one)
    gy = torch.where(even, 2.0 * one, 5.0 * one)
    gx = gx * torch.where((gid & 2) != 0, -one, one)
    gy = gy * torch.where((gid & 4) != 0, -one, one)
    return gx, gy


def _opensimplex2_core(grad_id, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The branchless 2-D cell walk: the vertices (1,0) and (0,1) always, the
    centre vertex of the cell's half and one extra vertex, each masked by its
    attenuation; `grad_id(xi, yi)` gives a lattice point's id in [0, 8)."""
    x, y = torch.broadcast_tensors(x, y)
    two_sq = float(np.float32(2.0 * SQUISH2))
    sq2 = float(np.float32(SQUISH2))
    stretch = (x + y) * float(np.float32(STRETCH2))
    xs, ys = x + stretch, y + stretch
    xsb_f, ysb_f = torch.floor(xs), torch.floor(ys)
    xsb, ysb = xsb_f.long(), ysb_f.long()
    xins, yins = xs - xsb_f, ys - ysb_f
    in_sum = xins + yins
    squish = (xsb_f + ysb_f) * sq2
    dx0 = x - (xsb_f + squish)
    dy0 = y - (ysb_f + squish)

    def contrib(dx, dy, xsv, ysv):
        attn = torch.clamp(2.0 - dx * dx - dy * dy, min=0.0)
        a2 = attn * attn
        gx, gy = _grad_components2(grad_id(xsv, ysv))
        return a2 * a2 * (gx * dx + gy * dy)

    value = contrib(dx0 - 1.0 - sq2, dy0 - sq2, xsb + 1, ysb)
    value = value + contrib(dx0 - sq2, dy0 - 1.0 - sq2, xsb, ysb + 1)

    region1 = in_sum <= 1.0
    xgty = xins > yins
    w = torch.where
    zins1 = 1.0 - in_sum
    near0 = (zins1 > xins) | (zins1 > yins)
    ex1 = w(near0, w(xgty, xsb + 1, xsb - 1), xsb + 1)
    ey1 = w(near0, w(xgty, ysb - 1, ysb + 1), ysb + 1)
    edx1 = w(near0, w(xgty, dx0 - 1.0, dx0 + 1.0), dx0 - 1.0 - two_sq)
    edy1 = w(near0, w(xgty, dy0 + 1.0, dy0 - 1.0), dy0 - 1.0 - two_sq)

    zins2 = 2.0 - in_sum
    far0 = (zins2 < xins) | (zins2 < yins)
    ex2 = w(far0, w(xgty, xsb + 2, xsb), xsb)
    ey2 = w(far0, w(xgty, ysb, ysb + 2), ysb)
    edx2 = w(far0, w(xgty, dx0 - 2.0 - two_sq, dx0 - two_sq), dx0)
    edy2 = w(far0, w(xgty, dy0 - two_sq, dy0 - 2.0 - two_sq), dy0)

    cxs = w(region1, xsb, xsb + 1)
    cys = w(region1, ysb, ysb + 1)
    cdx = w(region1, dx0, dx0 - 1.0 - two_sq)
    cdy = w(region1, dy0, dy0 - 1.0 - two_sq)
    value = value + contrib(cdx, cdy, cxs, cys)
    value = value + contrib(w(region1, edx1, edx2), w(region1, edy1, edy2),
                            w(region1, ex1, ex2), w(region1, ey1, ey2))
    return value / NORM2


def opensimplex2(perm: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Table-exact OpenSimplex 2-D noise: gradient id
    (perm[(perm[x & 255] + y) & 255] & 14) >> 1 from an int64 (256,) table."""
    return _opensimplex2_core(
        lambda xi, yi: (perm[(perm[xi & 0xFF] + yi) & 0xFF] & 0x0E) >> 1, x, y)


def opensimplex2_hash(seed: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Gather-free OpenSimplex 2-D noise: the gradient id is the low 3 bits
    of a lattice hash of (x, y, seed), in int64 masked to 32 bits."""
    def grad_id(xi, yi):
        m = lambda v: v.to(torch.int64) & _MASK32
        h = _mul32(m(xi), 0x8DA6B343) ^ _mul32(m(yi), 0xD8163841) ^ m(seed)
        h = h ^ (h >> 16)
        h = _mul32(h, 0x85EBCA6B)
        h = h ^ (h >> 13)
        return h & 7
    return _opensimplex2_core(grad_id, x, y)


def _grid(shape, device, lead=0):
    """fp32 row and column coordinates for the last two axes of `shape`,
    with `lead` leading axes of 1."""
    h, w = shape[-2:]
    pre = (1,) * lead
    yy = torch.arange(h, dtype=torch.float32, device=device).view(pre + (h, 1))
    xx = torch.arange(w, dtype=torch.float32, device=device).view(pre + (1, w))
    return yy, xx


def fractal2(perm: torch.Tensor, shape_hw, octaves: int = 1,
             persistence: float = 0.5, frequency: float = 32.0) -> torch.Tensor:
    """(H, W) octave sum of table-exact 2-D noise at (w, h) * 2^o / f."""
    yy, xx = _grid(shape_hw, perm.device)
    out = torch.zeros(tuple(shape_hw), dtype=torch.float32, device=perm.device)
    for scale, amp in octave_schedule(octaves, persistence, frequency):
        out = out + amp * opensimplex2(perm, xx * scale, yy * scale)
    return out


def batched_fractal2(seeds: torch.Tensor, shape_hw, octaves: int = 6,
                     persistence: float = 0.8, frequency: float = 64.0) -> torch.Tensor:
    """n independent 2-D octave fields (n, H, W) of the hash path, field i
    from lattice-hash seed `seeds[i]` (int64 holding a uint32).  Plain
    PyTorch on every device."""
    n = seeds.shape[0]
    yy, xx = _grid(shape_hw, seeds.device, lead=1)
    seed = seeds.view(n, 1, 1)
    out = torch.zeros((n,) + tuple(shape_hw), dtype=torch.float32,
                      device=seeds.device)
    for scale, amp in octave_schedule(octaves, persistence, frequency):
        out = out + amp * opensimplex2_hash(seed, xx * scale, yy * scale)
    return out


def batched_fractal3_fixed_t_table(perms: torch.Tensor, grad_id3s: torch.Tensor,
                                   t: torch.Tensor, shape_hw, octaves: int = 6,
                                   persistence: float = 0.8,
                                   frequency: float = 64.0) -> torch.Tensor:
    """n table-exact octave fields (n, H, W): field i from permutation
    `perms[i]` (and its gradient ids) on the plane z = `t[i]`.  Plain
    PyTorch on every device."""
    n = perms.shape[0]
    yy, xx = _grid(shape_hw, perms.device, lead=1)
    tt = t.to(torch.float32).view(n, 1, 1)
    out = torch.zeros((n,) + tuple(shape_hw), dtype=torch.float32,
                      device=perms.device)
    for scale, amp in octave_schedule(octaves, persistence, frequency):
        out = out + amp * opensimplex3(perms, grad_id3s, xx * scale,
                                       yy * scale, tt * scale)
    return out


def fractal3_fixed_t(perm: torch.Tensor, grad_id3: torch.Tensor, shape_hw, t,
                     octaves: int = 6, persistence: float = 0.8,
                     frequency: float = 64.0) -> torch.Tensor:
    """(H, W) octave sum of table-exact 3-D noise on the plane z = t."""
    t = torch.as_tensor(t, dtype=torch.float32, device=perm.device).reshape(1)
    return batched_fractal3_fixed_t_table(perm[None], grad_id3[None], t, shape_hw,
                                          octaves, persistence, frequency)[0]


def fractal3_volume(perm: torch.Tensor, grad_id3: torch.Tensor, shape_zhw,
                    octaves: int = 1, persistence: float = 0.5,
                    frequency: float = 32.0) -> torch.Tensor:
    """(Z, H, W) octave sum of table-exact 3-D noise at (w, h, z) * 2^o / f:
    plane z is the fixed-t field at t = z."""
    z = shape_zhw[0]
    t = torch.arange(z, dtype=torch.float32, device=perm.device)
    return batched_fractal3_fixed_t_table(
        perm.expand(z, 256), grad_id3.expand(z, 256), t, shape_zhw[1:],
        octaves, persistence, frequency)


def fractal3_fixed_t_hash(seed: torch.Tensor, shape_hw, t, octaves: int = 6,
                          persistence: float = 0.8,
                          frequency: float = 64.0) -> torch.Tensor:
    """One (H, W) hash-path octave field on the plane z = t: kernel K1 with
    n = 1 for a seed on the card."""
    seeds = torch.as_tensor(seed, dtype=torch.int64).reshape(1)
    tt = torch.as_tensor(t, dtype=torch.float32, device=seeds.device).reshape(1)
    return batched_fractal3_fixed_t(seeds, tt, shape_hw, octaves, persistence,
                                    frequency)[0]


def fractal3_volume_hash(seed: torch.Tensor, shape_zhw, octaves: int = 1,
                         persistence: float = 0.5,
                         frequency: float = 32.0) -> torch.Tensor:
    """(Z, H, W) hash-path octave volume at (w, h, z) * 2^o / f: plane z is
    the fixed-t field at t = z, so the volume is one K1 launch of Z copies
    of the seed on the card."""
    z, h, w = shape_zhw
    seeds = torch.as_tensor(seed, dtype=torch.int64).reshape(1).expand(z)
    t = torch.arange(z, dtype=torch.float32, device=seeds.device)
    return batched_fractal3_fixed_t(seeds.contiguous(), t, (h, w), octaves,
                                    persistence, frequency)


def octave_schedule(octaves: int, persistence: float, frequency: float):
    """fp32 (scale, amplitude) per octave: scale (1/f) * 2^o and amplitude a
    running fp32 product of the persistence, as the kernel computes them
    (every field of this module sums its octaves with these)."""
    scale = np.float32(1.0) / np.float32(frequency)
    amp = np.float32(1.0)
    out = []
    for _ in range(int(octaves)):
        out.append((float(scale), float(amp)))
        scale = np.float32(scale * np.float32(2.0))
        amp = np.float32(amp * np.float32(persistence))
    return out


def _fractal3_fixed_t_plain(seeds: torch.Tensor, t: torch.Tensor,
                            shape_hw, octaves: int, persistence: float,
                            frequency: float) -> torch.Tensor:
    """Plain PyTorch version of kernel K1: (n, H, W) fp32."""
    n = seeds.shape[0]
    yy, xx = _grid(shape_hw, seeds.device, lead=1)
    tt = t.to(torch.float32).view(n, 1, 1)
    seed = seeds.view(n, 1, 1)
    acc = torch.zeros((n,) + tuple(shape_hw), dtype=torch.float32,
                      device=seeds.device)
    for scale, amp in octave_schedule(octaves, persistence, frequency):
        v = opensimplex3_hash(seed, xx * scale, yy * scale, tt * scale)
        acc = acc + amp * v
    return acc


MAX_OCTAVES = 10  # the octave bound of the parameters-from-device entry


def _fractal3_fixed_t_params_plain(seeds: torch.Tensor, t: torch.Tensor,
                                   shape_hw, params: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1's parameters-from-device entry: (n, H, W)
    fp32 with (octaves, persistence, frequency) = params, a (3,) fp32
    tensor.  The loop runs MAX_OCTAVES octaves and zeroes the amplitude of
    those past the count, so nothing is read back to the host."""
    n = seeds.shape[0]
    h, w = shape_hw
    dev = seeds.device
    yy, xx = _grid(shape_hw, dev, lead=1)
    tt = t.to(torch.float32).view(n, 1, 1)
    seed = seeds.view(n, 1, 1)
    params = params.to(torch.float32)
    octaves, persistence = params[0], params[1]
    scale = 1.0 / params[2]
    amp = torch.ones((), dtype=torch.float32, device=dev)
    acc = torch.zeros((n, h, w), dtype=torch.float32, device=dev)
    for o in range(MAX_OCTAVES):
        v = opensimplex3_hash(seed, xx * scale, yy * scale, tt * scale)
        acc = acc + torch.where(o < octaves, amp, 0.0) * v
        amp = amp * persistence
        scale = scale * 2.0
    return acc


# Each warp of kernel K1 covers TILE_H x TILE_W pixels of one field: the
# WARP_H x WARP_W of csrc/simplex3_octave_field.cu.
TILE_H, TILE_W = 4, 8


def launch_plan(n: int, h: int, w: int, warps_per_block: int,
                resident: int) -> int:
    """Blocks of the K1 launch for n fields of h x w pixels, with blocks of
    `warps_per_block` warps on a card that holds `resident` blocks at once:
    as many as the card holds, fewer only when there are fewer tiles than
    warps (the warps walk the tiles grid-stride).  Raises on what the
    kernel does not take."""
    if n < 1 or h < 1 or w < 1:
        raise ValueError(f"batched_fractal3_fixed_t: empty output ({n}, {h}, {w})")
    if warps_per_block < 1 or resident < 1:
        raise ValueError(f"batched_fractal3_fixed_t: {resident} resident "
                         f"blocks of {warps_per_block} warps")
    tiles = n * -(-h // TILE_H) * -(-w // TILE_W)
    if tiles >= 2 ** 30 or max(h, w) > 2 ** 30:
        raise ValueError(f"batched_fractal3_fixed_t: ({n}, {h}, {w}) exceeds "
                         "the kernel's int32 tile index")
    return min(-(-tiles // warps_per_block), resident)


class Attributes(NamedTuple):
    """Kernel K1 as built for one card (`cudaFuncGetAttributes` and
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    registers: int          # per thread
    local_bytes: int        # per thread: spills
    shared_bytes: int       # static, per block
    threads: int            # per block
    blocks_per_sm: int      # resident at once
    resident: int           # blocks_per_sm x the card's SMs


@functools.cache
def _kernel():
    """The built library and its C entry, with argument types declared."""
    lib = _build.load("simplex3_octave_field")
    fn = lib.simplex3_octave_field
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dp = lib.simplex3_octave_field_device_params
    dp.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    dp.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def attributes(device: int) -> Attributes:
    """K1's registers, spills and occupancy on card `device`: the worse of
    its two entries', which share one launch plan."""
    lib, _ = _kernel()
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        status = lib.simplex3_octave_field_attributes(out)
    _build.check(lib, status, "simplex3_octave_field attributes")
    regs, local, shared, threads, per_sm = out
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return Attributes(regs, local, shared, threads, per_sm, per_sm * sms)


@functools.lru_cache(maxsize=None)
def _launch_args(n: int, h: int, w: int, octaves: int, persistence: float,
                 frequency: float, device: int):
    """The kernel's arguments after the three pointers, up to the stream:
    worked out and checked once per call signature."""
    attr = attributes(device)
    blocks = launch_plan(n, h, w, attr.threads // 32, attr.resident)
    return (n, int(h), int(w), int(octaves), float(persistence), float(frequency),
            blocks)


def batched_fractal3_fixed_t(seeds: torch.Tensor, t: torch.Tensor, shape_hw,
                             octaves: int = 6, persistence: float = 0.8,
                             frequency: float = 64.0) -> torch.Tensor:
    """n independent octave fields (n, H, W) fp32, field i from lattice-hash
    seed `seeds[i]` (int64 holding a uint32) on the plane z = `t[i]`.

    Tensors on the card launch kernel K1; tensors on the CPU take the plain
    version."""
    n = seeds.shape[0]
    if seeds.dim() != 1 or t.shape != (n,):
        raise ValueError(f"seeds and t must both be (n,), got "
                         f"{tuple(seeds.shape)} and {tuple(t.shape)}")
    if seeds.is_cpu:
        return _fractal3_fixed_t_plain(seeds, t, shape_hw, octaves,
                                       persistence, frequency)
    seeds, t = _card_inputs(seeds, t)
    h, w = shape_hw
    if n == 0:
        return seeds.new_empty((0, h, w), dtype=torch.float32)
    device = seeds.get_device()
    args = _launch_args(n, h, w, octaves, persistence, frequency, device)
    out = seeds.new_empty((n, h, w), dtype=torch.float32)
    lib, fn = _kernel()
    status = fn(seeds.data_ptr(), t.data_ptr(), out.data_ptr(), *args,
                torch._C._cuda_getCurrentRawStream(device))
    _build.check(lib, status, "simplex3_octave_field")
    batched_fractal3_fixed_t.launches += 1
    return out


batched_fractal3_fixed_t.launches = 0


def _card_inputs(seeds: torch.Tensor, t: torch.Tensor):
    """seeds as contiguous int64 and t as contiguous fp32 on one card, or
    raise."""
    if not seeds.is_cuda or t.device != seeds.device:
        raise ValueError(f"seeds on {seeds.device} and t on {t.device}: "
                         "both must be on one CUDA device or the CPU")
    if seeds.dtype is not torch.int64 or not seeds.is_contiguous():
        seeds = seeds.to(torch.int64).contiguous()
    if t.dtype is not torch.float32 or not t.is_contiguous():
        t = t.to(torch.float32).contiguous()
    return seeds, t


def batched_fractal3_fixed_t_params(seeds: torch.Tensor, t: torch.Tensor,
                                    shape_hw, params: torch.Tensor) -> torch.Tensor:
    """`batched_fractal3_fixed_t` with (octaves, persistence, frequency)
    taken from `params`, a (3,) fp32 tensor on the seeds' device, so that a
    triple drawn on the card needs no host sync: the octave count is a whole
    number up to MAX_OCTAVES.

    Tensors on the card launch K1's parameters-from-device entry, counted
    with K1's launches (`batched_fractal3_fixed_t.launches`); tensors on the
    CPU take the plain version."""
    n = seeds.shape[0]
    if seeds.dim() != 1 or t.shape != (n,) or params.shape != (3,):
        raise ValueError(f"seeds and t must both be (n,) and params (3,), got "
                         f"{tuple(seeds.shape)}, {tuple(t.shape)} and "
                         f"{tuple(params.shape)}")
    if seeds.is_cpu:
        return _fractal3_fixed_t_params_plain(seeds, t, shape_hw, params)
    seeds, t = _card_inputs(seeds, t)
    if params.device != seeds.device:
        raise ValueError(f"params on {params.device}, seeds on {seeds.device}")
    h, w = shape_hw
    if n == 0:
        return seeds.new_empty((0, h, w), dtype=torch.float32)
    params = params.to(torch.float32).contiguous()
    device = seeds.get_device()
    attr = attributes(device)
    blocks = launch_plan(n, h, w, attr.threads // 32, attr.resident)
    out = seeds.new_empty((n, h, w), dtype=torch.float32)
    lib, _ = _kernel()
    status = lib.simplex3_octave_field_device_params(
        seeds.data_ptr(), t.data_ptr(), params.data_ptr(), out.data_ptr(), n,
        int(h), int(w), blocks, torch._C._cuda_getCurrentRawStream(device))
    _build.check(lib, status, "simplex3_octave_field_device_params")
    batched_fractal3_fixed_t.launches += 1
    return out
