"""Multi-octave 3-D OpenSimplex noise, hash path (kernel K1).

Counterpart of the hash path of `anoddpm_tpu/ops/simplex.py`: the branchless
OpenSimplex cell walk (8 region-gated cube corners plus 2 extra vertices)
with gradients chosen by a murmur-style lattice hash mod 24 and rebuilt
arithmetically, summed over octaves on a fixed z = t plane.

`batched_fractal3_fixed_t` launches the CUDA kernel
`csrc/simplex3_octave_field.cu` for tensors on the card and computes the
plain PyTorch version below for tensors on the CPU.

The plain version computes the uint32 hash in int64, masked to 32 bits
after every multiply and shift: PyTorch on the CPU has no `>>`, `%` or `//`
for `torch.uint32`.  Its float operations are the kernel's, in the same
order, each rounded, so the two agree to the last bit away from float ties.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

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


def opensimplex3_hash(seed: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      z: torch.Tensor) -> torch.Tensor:
    """Gather-free OpenSimplex 3-D noise, elementwise over broadcast fp32
    x/y/z, with the gradient of each lattice point hashed from `seed`."""
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
        gx, gy, gz = _grad_components(
            _hash_grad_id(seed, xsb + ox, ysb + oy, zsb + oz))
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


def octave_schedule(octaves: int, persistence: float, frequency: float):
    """fp32 (scale, amplitude) per octave: scale (1/f) * 2^o and amplitude a
    running fp32 product of the persistence, as the kernel computes them."""
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
    h, w = shape_hw
    dev = seeds.device
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    tt = t.to(torch.float32).view(n, 1, 1)
    seed = seeds.view(n, 1, 1)
    acc = torch.zeros((n, h, w), dtype=torch.float32, device=dev)
    for scale, amp in octave_schedule(octaves, persistence, frequency):
        v = opensimplex3_hash(seed, xx * scale, yy * scale, tt * scale)
        acc = acc + amp * v
    return acc


@functools.cache
def _kernel():
    """The built library and its C entry, with argument types declared."""
    lib = _build.load("simplex3_octave_field")
    fn = lib.simplex3_octave_field
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


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
    if seeds.device.type == "cpu":
        return _fractal3_fixed_t_plain(seeds, t, shape_hw, octaves,
                                       persistence, frequency)
    if seeds.device.type != "cuda" or t.device != seeds.device:
        raise ValueError(f"seeds on {seeds.device} and t on {t.device}: "
                         "both must be on one CUDA device or the CPU")
    h, w = (int(s) for s in shape_hw)
    seeds = seeds.to(torch.int64).contiguous()
    t = t.to(torch.float32).contiguous()
    out = torch.empty((n, h, w), dtype=torch.float32, device=seeds.device)
    if n == 0:
        return out
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(seeds.device).cuda_stream
    status = fn(seeds.data_ptr(), t.data_ptr(), out.data_ptr(), n, h, w,
                int(octaves), float(persistence), float(frequency), stream)
    _build.check(lib, status, "simplex3_octave_field")
    batched_fractal3_fixed_t.launches += 1
    return out


batched_fractal3_fixed_t.launches = 0
