"""Fused GroupNorm(32) + affine + SiLU (kernel K2).

Counterpart of `anoddpm_tpu/ops/pallas_norm.py`: fp32 statistics
(mean and rstd = rsqrt(E[x^2] - mean^2 + eps) per (sample, group)), then
silu(x * rstd * gamma + (beta - mean * rstd * gamma)) in x's dtype.

For NCHW-contiguous x on the card, `group_norm_silu` launches the CUDA
kernel `csrc/group_norm_silu.cu`, at every shape (the TPU kernel's VMEM
eligibility gate has no counterpart here).  For x on the CPU it computes
the plain PyTorch version below.  The backward belongs to the training
slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

GROUPS = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Elements one pass-1 block reduces; a 256^2 x 256 group at batch 4 gives
# 4 * 32 * 128 = 16384 blocks, a 8^2 x 512 group 128 blocks.
_CHUNK_ELEMS = 4096


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
    """The built library and its C entry, with argument types declared."""
    lib = _build.load("group_norm_silu")
    fn = lib.group_norm_silu_forward
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(x, gamma, beta):
    if x.dim() < 2 or x.shape[1] % GROUPS:
        raise ValueError(f"x must be (N, C, ...) with C divisible by {GROUPS}, "
                         f"got {tuple(x.shape)}")
    c = x.shape[1]
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma and beta must be ({c},), got "
                         f"{tuple(gamma.shape)} and {tuple(beta.shape)}")


def group_norm_silu_with_stats(x: torch.Tensor, gamma: torch.Tensor,
                               beta: torch.Tensor, eps: float = 1e-5):
    """silu(group_norm_32(x) * gamma + beta) in x's dtype, plus the fp32
    per-(sample, group) mean and rstd, each (N, 32)."""
    _check(x, gamma, beta)
    if x.device.type == "cpu":
        return _plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"group_norm_silu: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm_silu: x must be NCHW-contiguous")
    n, c = x.shape[:2]
    hw = x[0, 0].numel()
    if n > 65535:
        raise ValueError(f"group_norm_silu: N = {n} exceeds the grid's z")
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.to(device=x.device, dtype=torch.float32).contiguous()
    group_len = (c // GROUPS) * hw
    chunks = max(1, -(-group_len // _CHUNK_ELEMS))
    out = torch.empty_like(x)
    mean = torch.empty((n, GROUPS), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    partial = torch.empty((n, GROUPS, chunks, 2), dtype=torch.float32,
                          device=x.device)
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                out.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                partial.data_ptr(), n, c, hw, chunks, float(eps),
                _DTYPE_CODES[x.dtype], stream)
    _build.check(lib, status, "group_norm_silu")
    group_norm_silu.launches += 1
    return out, mean, rstd


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """silu(group_norm_32(x) * gamma + beta) for NCHW x (fp32 or bf16), with
    fp32 statistics and the output in x's dtype."""
    return group_norm_silu_with_stats(x, gamma, beta, eps)[0]


group_norm_silu.launches = 0
