"""Fused GroupNorm(32) + affine + SiLU (kernel K2).

Counterpart of `anoddpm_tpu/ops/pallas_norm.py`: fp32 statistics
(mean and rstd = rsqrt(E[x^2] - mean^2 + eps) per (sample, group)), then
silu(x * rstd * gamma + (beta - mean * rstd * gamma)) in x's dtype.

For NCHW-contiguous x on the card, `group_norm_silu` launches the CUDA
kernel `csrc/group_norm_silu.cu` once, at every shape (the TPU kernel's
VMEM eligibility gate has no counterpart here), with the layout that `plan`
picks.  For x on the CPU it computes the plain PyTorch version below.  The
backward belongs to the training slice.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

GROUPS = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Layout limits (H100): a block stages at most 96 KB, so that two fit on an
# SM beside each other, and aims at 64 KB (three); a cluster holds at most
# 16 blocks (above 8 is non-portable); 256 threads a block.
SLICE_BYTES = 64 * 1024
STAGE_MAX_BYTES = 96 * 1024
MAX_CLUSTER = 16
MAX_THREADS = 256


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


@functools.lru_cache(maxsize=None)
def plan(n: int, c: int, hw: int, dtype: torch.dtype) -> Plan:
    """The launch layout for an (n, c, H W) x of `dtype`; raises on what
    the kernel does not take."""
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
    size = torch.finfo(dtype).bits // 8
    width = 16 // size                       # elements in 16 bytes
    cluster = 1
    while cluster < MAX_CLUSTER and group_len * size > cluster * SLICE_BYTES:
        cluster *= 2
    vectors = -(-group_len // (cluster * width))
    slice_len = vectors * width
    cluster = -(-group_len // slice_len)     # no block without elements
    if n * GROUPS * cluster >= 2 ** 31:
        raise ValueError(f"group_norm_silu: N = {n} exceeds the grid")
    threads = min(MAX_THREADS, max(32, 1 << (vectors - 1).bit_length()))
    staged = slice_len * size <= STAGE_MAX_BYTES and hw % width == 0
    return Plan(cluster, slice_len, threads, slice_len * size if staged else 0)


def _plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           eps: float):
    """Plain PyTorch version of kernel K2: (out, mean, rstd)."""
    n, c = x.shape[:2]
    cg = c // GROUPS
    xf = x.float()
    xg = xf.reshape(n, GROUPS, -1)
    mean = xg.mean(dim=-1)
    var = torch.clamp((xg * xg).mean(dim=-1) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    scale = rstd.repeat_interleave(cg, dim=1) * gamma.float()          # (n, c)
    shift = beta.float() - mean.repeat_interleave(cg, dim=1) * scale
    bshape = (n, c) + (1,) * (x.dim() - 2)
    y = xf * scale.view(bshape) + shift.view(bshape)
    return (y * torch.sigmoid(y)).to(x.dtype), mean, rstd


@functools.cache
def _kernel():
    """The built library and its C entries, with argument types declared."""
    lib = _build.load("group_norm_silu")
    fn = lib.group_norm_silu_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    prepare = lib.group_norm_silu_prepare
    prepare.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    prepare.restype = ctypes.c_int
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


def _check(x, gamma, beta):
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


def _forward(x, gamma, beta, eps, with_stats):
    """Kernel K2 on x's card: (out, stats), stats the (2, N, 32) fp32 mean
    and rstd when `with_stats`, else None (the kernel then skips them)."""
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
                *dims, eps, code, torch._C._cuda_getCurrentRawStream(device))
    _build.check(lib, status, "group_norm_silu")
    group_norm_silu.launches += 1
    return out, stats


def group_norm_silu_with_stats(x: torch.Tensor, gamma: torch.Tensor,
                               beta: torch.Tensor, eps: float = 1e-5):
    """silu(group_norm_32(x) * gamma + beta) in x's dtype, plus the fp32
    per-(sample, group) mean and rstd, each (N, 32)."""
    _check(x, gamma, beta)
    if x.is_cpu:
        return _plain(x, gamma, beta, eps)
    out, stats = _forward(x, gamma, beta, eps, True)
    return out, stats[0], stats[1]


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """silu(group_norm_32(x) * gamma + beta) for NCHW x (fp32 or bf16), with
    fp32 statistics and the output in x's dtype."""
    _check(x, gamma, beta)
    if x.is_cpu:
        return _plain(x, gamma, beta, eps)[0]
    return _forward(x, gamma, beta, eps, False)[0]


group_norm_silu.launches = 0
