"""Fused GroupNorm(32) + affine + SiLU (kernel K2).

Counterpart of `anoddpm_tpu/ops/pallas_norm.py`: fp32 statistics
(mean and rstd = rsqrt(E[x^2] - mean^2 + eps) per (sample, group)), then
silu(x * rstd * gamma + (beta - mean * rstd * gamma)) in x's dtype.

For NCHW-contiguous x on the card, `group_norm_silu` launches the CUDA
kernel `csrc/group_norm_silu.cu` once, at every shape, with the layout that
`plan` picks.  For x on the CPU it computes the plain PyTorch version below.
The TPU kernel's VMEM gate, `eligible`, does not limit the kernel: the UNet
reads it only where it follows the JAX package's `pallas_norm` choice
(`models.unet`, `norm_impl="flax"`).

Under autograd (grad enabled and x, gamma or beta requiring grad) the call
goes through `GroupNormSiLU`, the counterpart of the JAX custom_vjp: its
forward is K2 with the statistics and keeps x, mean and rstd (never the
output); its backward is kernel K2b (`csrc/group_norm_silu_backward.cu`,
`group_norm_silu_backward`) on the card and `_plain_backward`, the closed
form of `pallas_norm._bwd`, on the CPU.  Without autograd the call stays
one K2 launch without statistics.

`order="flax"` computes the site as the JAX package's UNet does by default
(`anoddpm_tpu/models/unet.py:48-83`, flax's GroupNorm32 then `nn.silu`,
plain XLA there): the norm rounded to x's dtype, then SiLU op by op in that
dtype, with JAX's gradient; `bf16_path` is `GroupNorm32(bf16_path=...)`,
which changes only where the backward rounds.  On the card it is a mode of
the same kernels, K2 and K2b, counted apart (`flax_launches`); on the CPU
its plain version is `_flax_site` and its autograd (`group_norm_silu_flax`).
At a bf16 site both kernels read the flax order's SiLU from a table over
the bf16 value h (filled once per card at the prepare step, checked at all
65,536 h by `flax_table_probe`); `_flax_table_lookup` is its plain
counterpart, which the tests hold against the op-by-op `_JaxSiLU`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import NamedTuple

import torch

from . import _build

GROUPS = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The site's orders: K2's (the TPU kernel's) and flax's, and the kernels'
# codes for them (csrc: ORDER_*; the backward's flax order with bf16_path
# is its own code).
ORDERS = ("kernel", "flax")
_BACKWARD_ORDER_CODES = {("kernel", False): 0, ("flax", False): 1,
                         ("flax", True): 2}
# Layout limits (H100): a block stages at most 96 KB, so that two fit on an
# SM beside each other, and aims at 64 KB (three); a cluster holds at most
# 16 blocks (above 8 is non-portable); 256 threads a block.
SLICE_BYTES = 64 * 1024
STAGE_MAX_BYTES = 96 * 1024
MAX_CLUSTER = 16
MAX_THREADS = 256
# The JAX package's gate for its Pallas kernel (`anoddpm_tpu/ops/
# pallas_norm.py:50-60`): whole groups, full 128-lane rows, and one sample
# of at most 2 MiB in VMEM.
VMEM_SAMPLE_BYTES = 2 * 1024 * 1024


def eligible(shape, dtype: torch.dtype) -> bool:
    """True where the JAX package sends an NHWC (B, H, W, C) activation of
    `dtype` through its Pallas kernel (`pallas_norm.eligible`); the NCHW x
    of the port passes (n, h, w, c)."""
    if len(shape) != 4:
        return False
    _, h, w, c = shape
    if c % GROUPS or c % 128:
        return False
    return h * w * c * dtype.itemsize <= VMEM_SAMPLE_BYTES


class Plan(NamedTuple):
    """How one K2 launch covers x: each (n, g) group is cut into `cluster`
    slices of `slice_len` elements, one per block of `threads` threads; the
    blocks of a group form a thread-block cluster when there are several.
    A block stages its slice in `smem_bytes` of dynamic shared memory
    (0: the slice is read twice from global memory instead)."""
    cluster: int
    slice_len: int
    threads: int
    smem_bytes: int


def _layout(n: int, c: int, hw: int, dtype: torch.dtype, tensors: int,
            slice_bytes: int, stage_max: int, max_threads: int):
    """(cluster, slice_len, threads, smem_bytes) of a launch that cuts each
    (n, g) group of `tensors` NCHW tensors of shape (n, c, H W) and `dtype`
    into `cluster` slices of about `slice_bytes` (all tensors together), one
    per block of at most `max_threads` threads, and stages a slice when its
    bytes are at most `stage_max`; raises on what the kernels do not take."""
    if c <= 0 or c % GROUPS:
        raise ValueError(f"group_norm_silu: C = {c} is not a positive "
                         f"multiple of {GROUPS}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"group_norm_silu: x must be float32 or bfloat16, "
                        f"got {dtype}")
    group_len = c // GROUPS * hw
    if n <= 0 or hw <= 0:
        raise ValueError(f"group_norm_silu: empty x ({n}, {c}, {hw})")
    if group_len >= 2 ** 31:
        raise ValueError(f"group_norm_silu: {group_len} elements per group "
                         "exceed int32")
    size = torch.finfo(dtype).bits // 8 * tensors   # bytes per element
    width = 16 * tensors // size                    # elements in 16 bytes
    cluster = 1
    while cluster < MAX_CLUSTER and group_len * size > cluster * slice_bytes:
        cluster *= 2
    vectors = -(-group_len // (cluster * width))
    slice_len = vectors * width
    cluster = -(-group_len // slice_len)     # no block without elements
    if n * GROUPS * cluster >= 2 ** 31:
        raise ValueError(f"group_norm_silu: N = {n} exceeds the grid")
    threads = min(max_threads, max(32, 1 << (vectors - 1).bit_length()))
    staged = slice_len * size <= stage_max and hw % width == 0
    return cluster, slice_len, threads, slice_len * size if staged else 0


@functools.lru_cache(maxsize=None)
def plan(n: int, c: int, hw: int, dtype: torch.dtype) -> Plan:
    """K2's launch layout for an (n, c, H W) x of `dtype`; raises on what
    the kernel does not take."""
    return Plan(*_layout(n, c, hw, dtype, 1, SLICE_BYTES, STAGE_MAX_BYTES,
                         MAX_THREADS))


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 for fp32 and narrower x, float64 for float64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           eps: float):
    """Plain PyTorch version of kernel K2: (out, mean, rstd)."""
    n, c = x.shape[:2]
    cg = c // GROUPS
    acc = _acc_dtype(x)
    xf = x.to(acc)
    xg = xf.reshape(n, GROUPS, -1)
    mean = xg.mean(dim=-1)
    var = torch.clamp((xg * xg).mean(dim=-1) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    scale = rstd.repeat_interleave(cg, dim=1) * gamma.to(acc)          # (n, c)
    shift = beta.to(acc) - mean.repeat_interleave(cg, dim=1) * scale
    bshape = (n, c) + (1,) * (x.dim() - 2)
    y = xf * scale.view(bshape) + shift.view(bshape)
    return (y * torch.sigmoid(y)).to(x.dtype), mean, rstd


def _plain_backward(x: torch.Tensor, grad_out: torch.Tensor,
                    gamma: torch.Tensor, beta: torch.Tensor,
                    mean: torch.Tensor, rstd: torch.Tensor):
    """Plain PyTorch version of kernel K2b, the closed form of
    `pallas_norm._bwd` in NCHW: (dx in x's dtype, dgamma, dbeta in fp32)."""
    n, c = x.shape[:2]
    cg = c // GROUPS
    acc = _acc_dtype(x)
    bshape = (n, c) + (1,) * (x.dim() - 2)
    cshape = (1, c) + (1,) * (x.dim() - 2)
    mean_c = mean.to(acc).repeat_interleave(cg, dim=1).view(bshape)
    rstd_c = rstd.to(acc).repeat_interleave(cg, dim=1).view(bshape)
    g = gamma.to(acc).view(cshape)
    xhat = (x.to(acc) - mean_c) * rstd_c
    z = xhat * g + beta.to(acc).view(cshape)
    sig = torch.sigmoid(z)
    dz = grad_out.to(acc) * sig * (1.0 + z * (1.0 - sig))
    dims = (0,) + tuple(range(2, x.dim()))
    dgamma = (dz * xhat).sum(dim=dims)
    dbeta = dz.sum(dim=dims)
    dxhat = dz * g
    m1 = dxhat.reshape(n, GROUPS, -1).mean(dim=-1)
    m2 = (dxhat * xhat).reshape(n, GROUPS, -1).mean(dim=-1)
    m1 = m1.repeat_interleave(cg, dim=1).view(bshape)
    m2 = m2.repeat_interleave(cg, dim=1).view(bshape)
    dx = (dxhat - m1 - xhat * m2) * rstd_c
    return dx.to(x.dtype), dgamma, dbeta


def _jax_logistic(x):
    """JAX's logistic of x on the CPU, in x's dtype: `torch.sigmoid` in fp32,
    1 / (1 + exp(-x)) op by op in a narrower dtype."""
    if x.dtype in (torch.float32, torch.float64):
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


# The flax order's table over the bf16 value h (csrc/cluster_staging.cuh,
# `flax_table_index`): per sign, slot 0 for |h| < 2^-8, slots 1..1920 for
# the bf16 values of |h| in [2^-8, 2^7), 1921 for |h| >= 2^7 and inf, 1922
# for NaN.
FLAX_TABLE_ROW = 1923
_FLAX_TABLE_LO = 119 << 7            # bits of 2^-8, sign off
_BF16_INF = 0x7F80


def _flax_table_index(bits: torch.Tensor) -> torch.Tensor:
    """The slot of each bf16 value given by its 16 bits (int32 0..65535)."""
    e = bits & 0x7FFF
    k = (e - _FLAX_TABLE_LO + 1).clamp(0, 1921) + (e > _BF16_INF).int()
    return (bits >> 15) * FLAX_TABLE_ROW + k


def _bf16_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The bf16 values with the given 16 bits (int32)."""
    return (bits << 16).view(torch.float32).to(torch.bfloat16)


def _flax_table_h() -> torch.Tensor:
    """The bf16 h that fills each slot: +-0, the range's values, +-inf, NaN."""
    k = torch.arange(FLAX_TABLE_ROW, dtype=torch.int32)
    e = torch.where(k == 0, 0, _FLAX_TABLE_LO + k - 1)
    e = torch.where(k == 1921, _BF16_INF, e)
    e = torch.where(k == 1922, 0x7FC0, e)
    return _bf16_from_bits(torch.cat([e, e | 0x8000]))


@functools.cache
def _plain_flax_table():
    """Plain version of the kernels' tables: per slot the bf16 (s, ds) of
    its h, op by op as `_JaxSiLU`."""
    s = _jax_logistic(_flax_table_h())
    return s, s * (1 - s)


def _flax_table_lookup(h: torch.Tensor):
    """(s, ds, out) of the bf16 values h, s and ds read from the plain table
    and out = h s: the kernels' lookup on the CPU (the tests hold it against
    `_JaxSiLU`)."""
    bits = h.view(torch.int16).int() & 0xFFFF
    i = _flax_table_index(bits).long()
    s, ds = (t[i] for t in _plain_flax_table())
    return s, ds, h * s


class _JaxSiLU(torch.autograd.Function):
    """x * logistic(x) as the JAX package computes it on the CPU: in fp32
    `torch.sigmoid`; in a narrower dtype 1 / (1 + exp(-x)), each op rounded
    to that dtype, as XLA expands a bf16 logistic.  The gradient is JAX's
    for the product with its logistic rule, g * s + (g * x) * (s * (1 - s)),
    each op in x's dtype (torch's autograd of the expansion is another
    chain of roundings)."""

    @staticmethod
    def forward(ctx, x):
        s = _jax_logistic(x)
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def _flax_site_with_stats(x, gamma, beta, bf16_path: bool, silu: bool,
                          eps: float = 1e-5):
    """`_flax_site`, and its fp32 (N, 32) mean and rsqrt(var + eps)."""
    n, c = x.shape[:2]
    xs = x.float()
    xc = x.float() if bf16_path else xs
    xg = xs.reshape(n, GROUPS, -1)
    mean = xg.mean(dim=-1)
    var = torch.clamp((xg * xg).mean(dim=-1) - mean * mean, min=0.0)
    # correctly rounded: torch's and XLA's fp32 rsqrt each err by up to ~1.5
    # ulps, in different places
    rstd = torch.rsqrt((var + eps).double()).float()
    cg = c // GROUPS
    bshape = (n, c) + (1,) * (x.dim() - 2)
    mul = rstd.repeat_interleave(cg, dim=1) * gamma
    y = ((xc - mean.repeat_interleave(cg, dim=1).view(bshape)) * mul.view(bshape)
         + beta.view((1, c) + (1,) * (x.dim() - 2)))
    y = y.to(x.dtype)
    return (_JaxSiLU.apply(y) if silu else y), mean, rstd


def _flax_site(x, gamma, beta, bf16_path: bool, silu: bool, eps: float = 1e-5):
    """flax's GroupNorm(32) on NCHW x (`normalization._compute_stats` with
    the fast variance, then `_normalize`): fp32 mean and E[x^2], var =
    max(E[x^2] - mean^2, 0), y = (x - mean) * (rsqrt(var + eps) * gamma) +
    beta in fp32, rounded once to x's dtype; then `_JaxSiLU` when `silu`.
    With `bf16_path` the statistics and the centring each take their own
    fp32 copy of x, as flax's dtype promotion does, so that autograd rounds
    their gradients to x's dtype one by one and sums them there, as JAX
    transposes the two converts; without it one copy serves both and the
    gradient rounds once.  The forward is the same either way.  The plain
    version of the flax order."""
    return _flax_site_with_stats(x, gamma, beta, bf16_path, silu, eps)[0]


def _flax_site_grads(x, gamma, beta, grad, bf16_path: bool, silu: bool,
                     eps: float = 1e-5):
    """(dx, dgamma, dbeta) of `_flax_site` for the output gradient `grad`:
    the composition run again under autograd and differentiated."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, gamma, beta)]
        out = _flax_site(*inputs, bf16_path, silu, eps)
        return torch.autograd.grad(out, inputs, grad)


class _FlaxSite(torch.autograd.Function):
    """`_flax_site` under autograd, keeping only its inputs (K2's memory, not
    the composition's fp32 temporaries): the backward runs the composition
    again under autograd and differentiates it, so the gradient is the
    composition's own."""

    @staticmethod
    def forward(ctx, x, gamma, beta, bf16_path, silu, eps=1e-5):
        ctx.save_for_backward(x, gamma, beta)
        ctx.options = (bf16_path, silu, eps)
        return _flax_site(x, gamma, beta, bf16_path, silu, eps)

    @staticmethod
    def backward(ctx, grad):
        return (*_flax_site_grads(*ctx.saved_tensors, grad, *ctx.options),
                None, None, None)


def _plain_flax(x, gamma, beta, eps):
    """Plain PyTorch version of K2's flax order: (out, mean, rstd)."""
    return _flax_site_with_stats(x, gamma, beta, False, True, eps)


def _plain_flax_backward(x, grad_out, gamma, beta, bf16_path, eps):
    """Plain PyTorch version of K2b's flax order: (dx in x's dtype, dgamma,
    dbeta in gamma's dtype), the autograd of `_flax_site`."""
    return _flax_site_grads(x, gamma, beta, grad_out, bf16_path, True, eps)


@functools.cache
def _kernel():
    """The built library and its C entries, with argument types declared."""
    lib = _build.load("group_norm_silu")
    fn = lib.group_norm_silu_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    prepare = lib.group_norm_silu_prepare
    prepare.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    prepare.restype = ctypes.c_int
    probe = lib.group_norm_silu_flax_table_probe
    probe.argtypes = [ctypes.c_void_p] * 3
    probe.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _launch_args(shape: torch.Size, dtype: torch.dtype, device: int):
    """The kernel's shape and layout arguments for x of `shape` and `dtype`
    on card `device`, (n, c, hw, cluster, slice_len, threads, smem_bytes),
    and the dtype code; worked out and checked once per shape.  The first
    call also sets the kernel's attributes on the card, and raises if the
    card cannot hold one cluster of the layout."""
    n, c = shape[:2]
    hw = math.prod(shape[2:])
    p = plan(n, c, hw, dtype)
    code = _DTYPE_CODES[dtype]
    lib, _ = _kernel()
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = lib.group_norm_silu_prepare(code, p.cluster, p.threads,
                                             p.smem_bytes, ctypes.byref(count))
    _build.check(lib, status, "group_norm_silu prepare")
    if count.value < 1:
        raise RuntimeError(f"group_norm_silu: the card cannot schedule a "
                           f"cluster of {p}")
    return (n, c, hw) + tuple(p), code


def _check(x, gamma, beta, order="kernel", bf16_path=False):
    if order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, got {order!r}")
    if bf16_path and order != "flax":
        raise ValueError("bf16_path applies to the flax order only")
    if x.dim() < 2 or x.shape[1] % GROUPS:
        raise ValueError(f"x must be (N, C, ...) with C divisible by {GROUPS}, "
                         f"got {tuple(x.shape)}")
    c = x.shape[1]
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma and beta must be ({c},), got "
                         f"{tuple(gamma.shape)} and {tuple(beta.shape)}")


def _fp32_on(t: torch.Tensor, device: int) -> torch.Tensor:
    """t as fp32, contiguous, on card `device` (t itself if it is already)."""
    if (t.dtype is torch.float32 and t.is_cuda and t.get_device() == device
            and t.is_contiguous()):
        return t
    return t.to(device=torch.device("cuda", device), dtype=torch.float32
                ).contiguous()


def _forward(x, gamma, beta, eps, with_stats, order):
    """Kernel K2 in `order` on x's card: (out, stats), stats the (2, N, 32)
    fp32 mean and rstd when `with_stats`, else None (the kernel then skips
    them)."""
    if not x.is_cuda:
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu: x must be NCHW-contiguous")
    device = x.get_device()
    dims, code = _launch_args(x.shape, x.dtype, device)
    gamma, beta = _fp32_on(gamma, device), _fp32_on(beta, device)
    out = torch.empty_like(x)
    stats = (x.new_empty((2, dims[0], GROUPS), dtype=torch.float32)
             if with_stats else None)
    lib, fn = _kernel()
    status = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                out.data_ptr(), None if stats is None else stats.data_ptr(),
                *dims, eps, code, ORDERS.index(order),
                torch._C._cuda_getCurrentRawStream(device))
    _build.check(lib, status, "group_norm_silu")
    if order == "kernel":
        group_norm_silu.launches += 1
    else:
        group_norm_silu.flax_launches += 1
    return out, stats


def group_norm_silu_with_stats(x: torch.Tensor, gamma: torch.Tensor,
                               beta: torch.Tensor, eps: float = 1e-5,
                               order: str = "kernel"):
    """silu(group_norm_32(x) * gamma + beta) in x's dtype, in `order`, plus
    the fp32 per-(sample, group) mean and rstd, each (N, 32)."""
    _check(x, gamma, beta, order)
    if x.is_cpu:
        return (_plain if order == "kernel" else _plain_flax)(x, gamma, beta,
                                                              eps)
    out, stats = _forward(x, gamma, beta, eps, True, order)
    return out, stats[0], stats[1]


class BackwardPlan(NamedTuple):
    """How one K2b launch covers x and grad_out: each (n, g) group is cut
    into `cluster` slices of `slice_len` elements, one per block of
    `threads` threads; the blocks of a group form a thread-block cluster
    when there are several.  A block stages its slices of x and grad_out in
    `smem_bytes` of dynamic shared memory; where `smem_bytes` holds the
    slice of x alone, it reads grad_out twice from global memory instead,
    the second time mostly from L2; where it is 0, it reads both twice with
    scalar accesses."""
    cluster: int
    slice_len: int
    threads: int
    smem_bytes: int


BACKWARD_LAUNCHES = 2       # K2b's CUDA launches per call
# K2b's layout limits (H100): a block aims at 64 KB of x + grad_out (three
# blocks an SM) and stages up to 96 KB; the 2 MB groups at 256^2 (16 blocks
# of 128 KB) stage the slice of x alone and read grad_out twice, the second
# time mostly from L2, which `scripts/torch_k2b_layouts.py` timed faster
# than staging both one block an SM.  256 threads a block where both slices
# are staged, 512 where grad_out comes from global memory (more loads in
# flight): each was the faster on its side in that script's runs.
BACKWARD_SLICE_BYTES = 64 * 1024
BACKWARD_STAGE_MAX_BYTES = 96 * 1024
BACKWARD_MAX_THREADS = 256
BACKWARD_MAX_THREADS_READ_TWICE = 512   # csrc: MAX_THREADS


@functools.lru_cache(maxsize=None)
def backward_plan(n: int, c: int, hw: int, dtype: torch.dtype) -> BackwardPlan:
    """K2b's launch layout for an (n, c, H W) x and grad_out of `dtype`;
    raises on what the kernel does not take.  Where the slices of both do
    not fit the staging budget, the slice of x alone is staged if it fits."""
    cluster, slice_len, threads, smem = _layout(
        n, c, hw, dtype, 2, BACKWARD_SLICE_BYTES, BACKWARD_STAGE_MAX_BYTES,
        BACKWARD_MAX_THREADS)
    size = torch.finfo(dtype).bits // 8
    if not smem and hw % (16 // size) == 0 \
            and slice_len * size <= BACKWARD_STAGE_MAX_BYTES:
        smem = slice_len * size
    if smem < 2 * slice_len * size:          # grad_out read twice
        vectors = -(-slice_len * size // 16)
        threads = min(BACKWARD_MAX_THREADS_READ_TWICE,
                      max(32, 1 << (vectors - 1).bit_length()))
    return BackwardPlan(cluster, slice_len, threads, smem)


@functools.cache
def _backward_kernel():
    """The built K2b library and its C entries, with argument types declared
    (the call's arguments go as one packed `Call` struct)."""
    lib = _build.load("group_norm_silu_backward")
    fn = lib.group_norm_silu_backward
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    prepare = lib.group_norm_silu_backward_prepare
    prepare.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    prepare.restype = ctypes.c_int
    probe = lib.group_norm_silu_backward_flax_table_probe
    probe.argtypes = [ctypes.c_void_p] * 3
    probe.restype = ctypes.c_int
    return lib, fn


# csrc/group_norm_silu_backward.cu `Call`: 11 pointers (x, grad_out, gamma,
# beta, mean, rstd, dx, dgamma, dbeta, scratch, stream), then 9 ints (n, c,
# hw, cluster, slice_len, threads, smem, dtype code; the order's code), in
# native layout.
_CALL_POINTERS = struct.Struct("11P")
_CALL_INTS = struct.Struct("8i")
_CALL_ORDER = struct.Struct("i")


@functools.lru_cache(maxsize=None)
def _backward_launch_args(shape: torch.Size, dtype: torch.dtype, device: int):
    """K2b's packed shape and layout arguments for x of `shape` and `dtype`
    on card `device` (the ints of `Call`); worked out and checked once per
    shape.  The first call also sets the kernel's attributes on the card,
    and raises if the card cannot hold one cluster of the layout."""
    n, c = shape[:2]
    hw = math.prod(shape[2:])
    p = backward_plan(n, c, hw, dtype)
    code = _DTYPE_CODES[dtype]
    lib, _ = _backward_kernel()
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = lib.group_norm_silu_backward_prepare(
            code, c, p.cluster, p.threads, p.smem_bytes, ctypes.byref(count))
    _build.check(lib, status, "group_norm_silu_backward prepare")
    if count.value < 1:
        raise RuntimeError(f"group_norm_silu_backward: the card cannot "
                           f"schedule a cluster of {p}")
    return _CALL_INTS.pack(n, c, hw, *p, code)


def group_norm_silu_backward(x: torch.Tensor, grad_out: torch.Tensor,
                             gamma: torch.Tensor, beta: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             order: str = "kernel", bf16_path: bool = False,
                             eps: float = 1e-5):
    """The gradient of `group_norm_silu` in `order` (with `bf16_path`) at x
    for the output gradient `grad_out`, from the forward's (N, 32) mean and
    rstd: (dx in x's dtype, dgamma, dbeta in fp32).  Kernel K2b for x on the
    card (NCHW-contiguous x and grad_out of x's dtype), the plain version
    for x on the CPU (in the flax order the composition's autograd, which
    recomputes the statistics with `eps`)."""
    _check(x, gamma, beta, order, bf16_path)
    if x.is_cpu:
        if order == "flax":
            return _plain_flax_backward(x, grad_out, gamma, beta, bf16_path,
                                        eps)
        return _plain_backward(x, grad_out, gamma, beta, mean, rstd)
    if not x.is_cuda:
        raise ValueError(f"group_norm_silu_backward: unsupported device "
                         f"{x.device}")
    device = x.get_device()
    if grad_out.shape != x.shape or grad_out.dtype is not x.dtype \
            or grad_out.get_device() != device:
        raise ValueError("group_norm_silu_backward: grad_out must match x in "
                         "shape, dtype and device")
    if not (x.is_contiguous() and grad_out.is_contiguous()):
        raise ValueError("group_norm_silu_backward: x and grad_out must be "
                         "NCHW-contiguous")
    n, c = x.shape[:2]
    if mean.shape != (n, GROUPS) or rstd.shape != (n, GROUPS):
        raise ValueError(f"mean and rstd must be ({n}, {GROUPS})")
    ints = _backward_launch_args(x.shape, x.dtype, device)
    gamma, beta = _fp32_on(gamma, device), _fp32_on(beta, device)
    mean, rstd = _fp32_on(mean, device), _fp32_on(rstd, device)
    dx = torch.empty_like(x)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    scratch = gamma.new_empty(2 * n * c)    # the per-sample sums A, B
    lib, fn = _backward_kernel()
    status = fn(_CALL_POINTERS.pack(
        x.data_ptr(), grad_out.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), scratch.data_ptr(),
        torch._C._cuda_getCurrentRawStream(device)) + ints
        + _CALL_ORDER.pack(_BACKWARD_ORDER_CODES[order, bf16_path]))
    _build.check(lib, status, "group_norm_silu_backward")
    if order == "kernel":
        group_norm_silu_backward.launches += BACKWARD_LAUNCHES
    else:
        group_norm_silu_backward.flax_launches += BACKWARD_LAUNCHES
    return dx, dgamma, dbeta


group_norm_silu_backward.launches = 0
group_norm_silu_backward.flax_launches = 0


class GroupNormSiLU(torch.autograd.Function):
    """`group_norm_silu` under autograd (the JAX custom_vjp `_fwd`/`_bwd`):
    the forward keeps x, gamma, beta, mean and rstd; the backward is K2b, in
    the forward's order."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, order="kernel", bf16_path=False):
        out, mean, rstd = group_norm_silu_with_stats(x, gamma, beta, eps,
                                                     order)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.options = (order, bf16_path, eps)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = group_norm_silu_backward(
            x, grad_out.contiguous(), gamma, beta, mean, rstd, *ctx.options)
        need = ctx.needs_input_grad
        return (dx if need[0] else None,
                dgamma.to(gamma.dtype) if need[1] else None,
                dbeta.to(beta.dtype) if need[2] else None, None, None, None)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-5, order: str = "kernel",
                    bf16_path: bool = False) -> torch.Tensor:
    """silu(group_norm_32(x) * gamma + beta) for NCHW x (fp32 or bf16), with
    fp32 statistics and the output in x's dtype, in `order`: "kernel" (the
    TPU kernel's: SiLU in fp32, rounded once) or "flax" (the JAX UNet's
    default: the norm rounded, then SiLU op by op in x's dtype; `bf16_path`
    as flax's GroupNorm32's).  Differentiable: under autograd it goes
    through `GroupNormSiLU`."""
    _check(x, gamma, beta, order, bf16_path)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        if x.is_cpu and order == "flax":
            # the plain composition's own Function: through it a whole
            # UNet's gradients keep the bits they had before the order was
            # a kernel mode (autograd sums a tensor's gradients in an order
            # that follows the Functions it passed)
            return _FlaxSite.apply(x, gamma, beta, bf16_path, True, eps)
        return GroupNormSiLU.apply(x, gamma, beta, eps, order, bf16_path)
    if x.is_cpu:
        return (_plain if order == "kernel" else _plain_flax)(x, gamma, beta,
                                                              eps)[0]
    return _forward(x, gamma, beta, eps, False, order)[0]


group_norm_silu.launches = 0
group_norm_silu.flax_launches = 0


def group_norm_silu_flax(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, bf16_path: bool = False,
                         eps: float = 1e-5) -> torch.Tensor:
    """`group_norm_silu` in the flax order: the JAX package's
    `nn.silu(GroupNorm32(bf16_path)(x))` on NCHW x."""
    return group_norm_silu(x, gamma, beta, eps, "flax", bf16_path)


def flax_table_probe(device: int = 0):
    """Both kernels' flax-order tables against their direct computation at
    all 65,536 bf16 values of h, on card `device`: {"s": (table, direct)} as
    int16 bf16 bits from K2's library, {"s_ds": (table, direct)} as int32
    (s's bits high, ds's low) from K2b's, indexed by h's bits.  Fills the
    tables first if the card's are not filled yet."""
    dev = torch.device("cuda", device)
    stream = torch._C._cuda_getCurrentRawStream(device)
    out = {}
    for key, dtype, (lib, _), entry in (
            ("s", torch.int16, _kernel(), "group_norm_silu_flax_table_probe"),
            ("s_ds", torch.int32, _backward_kernel(),
             "group_norm_silu_backward_flax_table_probe")):
        pair = (torch.empty(65536, dtype=dtype, device=dev),
                torch.empty(65536, dtype=dtype, device=dev))
        with torch.cuda.device(device):
            status = getattr(lib, entry)(pair[0].data_ptr(), pair[1].data_ptr(),
                                         stream)
        _build.check(lib, status, entry)
        out[key] = pair
    return out
