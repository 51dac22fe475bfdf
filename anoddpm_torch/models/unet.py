"""Guided-diffusion UNet epsilon-predictor as an `nn.Module`.

Mirrors `anoddpm_tpu/models/unet.py`: ResBlocks with BigGAN-style in-block
up/downsampling, QKV attention at the configured resolutions, a sinusoidal
timestep embedding with a 2-layer SiLU MLP, GroupNorm(32) with fp32
statistics, zero-initialised output projections and optional
space-to-depth.  The layout is NCHW.

Submodules carry the flax tree's names (`down_0_0.norm_in`, `mid_attn.qkv`,
`out_conv`, ...), so converting flax parameters is a tree walk
(`anoddpm_torch.compat.flax_params`).

Precision mirrors flax's `dtype`: parameters are fp32; every conv and dense
casts its input and weight to the compute dtype; norms compute their
statistics in fp32 and return the activation dtype; `out_norm` and
`out_conv` run in fp32.  Every norm+SiLU site calls kernel K2
(`ops.group_norm_silu`) at every shape; the attention norm (GroupNorm
without SiLU, outside any kernel in the JAX package) is `F.group_norm` in
fp32.  The JAX package's `bf16_norm` and `pallas_norm` keys change only how
flax computes the same norms, so the port reads neither.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.group_norm_silu import group_norm_silu

# Per-resolution channel-multiplier defaults (reference UNet.py:239-251).
DEFAULT_CHANNEL_MULTS = {
    512: (0.5, 1, 1, 2, 2, 4, 4),
    256: (1, 1, 2, 2, 4, 4),
    128: (1, 1, 2, 3, 4),
    64: (1, 2, 3, 4),
    32: (1, 2, 3, 4),
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of the timestep, [sin | cos] halves, fp32."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / half))
    angles = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


class Conv(nn.Module):
    """Conv2d with 'SAME' padding whose input and weight are cast to the
    compute dtype (flax `nn.Conv(dtype=...)` with fp32 params)."""

    def __init__(self, cin: int, cout: int, kernel: int, dtype: torch.dtype,
                 zero: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype
        if zero:
            nn.init.zeros_(self.weight)
        else:  # fan-in normal, close to flax's lecun-normal default
            nn.init.normal_(self.weight, std=1.0 / math.sqrt(cin * kernel * kernel))

    def forward(self, x):
        w = self.weight
        return F.conv2d(x.to(self.dtype), w.to(self.dtype),
                        self.bias.to(self.dtype), padding=w.shape[-1] // 2)


class Dense(nn.Module):
    """Linear layer computed in the compute dtype (flax `nn.Dense`)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype,
                 zero: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype
        if zero:
            nn.init.zeros_(self.weight)
        else:
            nn.init.normal_(self.weight, std=1.0 / math.sqrt(cin))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class GroupNorm32(nn.Module):
    """GroupNorm(32) in fp32, returned in the activation dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x.float(), 32, self.weight, self.bias,
                            eps=1e-5).to(x.dtype)


class NormSiLU(GroupNorm32):
    """GroupNorm(32) + SiLU through kernel K2."""

    def forward(self, x):
        return group_norm_silu(x, self.weight, self.bias)


class ResBlock(nn.Module):
    """Residual block with timestep-embedding injection and optional
    BigGAN-style in-block resampling."""

    def __init__(self, cin: int, cout: int, time_dim: int, dtype: torch.dtype,
                 dropout: float = 0.0, up: bool = False, down: bool = False):
        super().__init__()
        self.up, self.down, self.dropout = up, down, dropout
        self.norm_in = NormSiLU(cin)
        self.conv_in = Conv(cin, cout, 3, dtype)
        self.emb_proj = Dense(time_dim, cout, dtype)
        self.norm_out = NormSiLU(cout)
        self.conv_out = Conv(cout, cout, 3, dtype, zero=True)
        self.skip = Conv(cin, cout, 1, dtype) if cin != cout else None

    def forward(self, x, emb):
        h = self.norm_in(x)
        if self.up:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif self.down:
            h = F.avg_pool2d(h, 2)
            x = F.avg_pool2d(x, 2)
        h = self.conv_in(h)
        h = h + self.emb_proj(F.silu(emb)).to(h.dtype)[:, :, None, None]
        h = self.norm_out(h)
        h = F.dropout(h, self.dropout, self.training)
        h = self.conv_out(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over the H*W positions: q and k each scaled by
    1/sqrt(sqrt(ch)), softmax in fp32, as plain matmuls."""

    def __init__(self, channels: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.norm = GroupNorm32(channels)
        self.qkv = Dense(channels, 3 * channels, dtype)
        self.proj = Dense(channels, channels, dtype, zero=True)

    def forward(self, x):
        b, c, hgt, wid = x.shape
        ch = c // self.heads
        h = self.norm(x).reshape(b, c, hgt * wid).transpose(1, 2)   # (B, L, C)
        qkv = self.qkv(h).reshape(b, hgt * wid, self.heads, 3 * ch)
        q, k, v = qkv.transpose(1, 2).split(ch, dim=-1)            # (B, H, L, ch)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        logits = torch.matmul(q * scale, (k * scale).transpose(-1, -2))
        weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        attended = torch.matmul(weights, v).transpose(1, 2).reshape(b, hgt * wid, c)
        proj = self.proj(attended)
        return x + proj.transpose(1, 2).reshape(b, c, hgt, wid)


def _space_to_depth(x, s):
    """NCHW counterpart of the JAX NHWC patchify: channel index
    (row offset * s + column offset) * C + c."""
    b, c, hh, ww = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, hh // s, s, ww // s, s, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh // s, ww // s, s * s * c)
    return x.permute(0, 3, 1, 2).contiguous()


def _depth_to_space(x, s, c):
    b, _, hh, ww = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, hh, ww, s, s, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh * s, ww * s, c)
    return x.permute(0, 3, 1, 2).contiguous()


class UNet(nn.Module):
    """The epsilon-predicting UNet.

    Input:  x (B, C, H, W), t (B,) integer timesteps.
    Output: eps estimate (B, C, H, W) fp32.
    """

    def __init__(self, img_size: int, base_channels: int, in_channels: int = 1,
                 channel_mults: Tuple[float, ...] = (), num_res_blocks: int = 2,
                 dropout: float = 0.0, attention_resolutions: str = "32,16,8",
                 n_heads: int = 1, n_head_channels: int = -1,
                 space_to_depth: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.s2d = space_to_depth
        self.base = base_channels
        size = img_size // space_to_depth
        mults = channel_mults or DEFAULT_CHANNEL_MULTS.get(size)
        if mults is None:
            raise ValueError(f"unsupported image size: {size}")
        # attention_resolutions are true-image resolutions; map them onto
        # the patchified grid
        attention_ds = [size // max(int(r) // space_to_depth, 1)
                        for r in str(attention_resolutions).split(",")]
        time_dim = base_channels * 4

        def heads_for(c):
            if n_head_channels == -1:
                return n_heads
            if c % n_head_channels:
                raise ValueError(f"channels {c} not divisible by "
                                 f"n_head_channels {n_head_channels}")
            return c // n_head_channels

        self.time_dense1 = Dense(base_channels, time_dim, dtype)
        self.time_dense2 = Dense(time_dim, time_dim, dtype)
        self.stem = Conv(in_channels * space_to_depth ** 2, base_channels, 3, dtype)

        # The call order: a block name, "push" (the activation joins the
        # skips) or "cat" (the next block takes the activation concatenated
        # with the last skip).
        plan = []

        def add(name, module):
            self.add_module(name, module)
            plan.append(name)

        res = lambda cin, cout, **kw: ResBlock(cin, cout, time_dim, dtype,
                                               dropout, **kw)
        attn = lambda c: AttentionBlock(c, heads_for(c), dtype)
        ch, ds, skips = base_channels, 1, [base_channels]
        for i, mult in enumerate(mults):
            out_ch = int(base_channels * mult)
            for j in range(num_res_blocks):
                add(f"down_{i}_{j}", res(ch, out_ch))
                ch = out_ch
                if ds in attention_ds:
                    add(f"down_attn_{i}_{j}", attn(ch))
                skips.append(ch)
                plan.append("push")
            if i != len(mults) - 1:
                add(f"down_sample_{i}", res(ch, ch, down=True))
                ds *= 2
                skips.append(ch)
                plan.append("push")
        add("mid_res1", res(ch, ch))
        add("mid_attn", attn(ch))
        add("mid_res2", res(ch, ch))
        for i, mult in reversed(list(enumerate(mults))):
            out_ch = int(base_channels * mult)
            for j in range(num_res_blocks + 1):
                plan.append("cat")
                add(f"up_{i}_{j}", res(ch + skips.pop(), out_ch))
                ch = out_ch
                if ds in attention_ds:
                    add(f"up_attn_{i}_{j}", attn(ch))
                if i and j == num_res_blocks:
                    add(f"up_sample_{i}", res(ch, ch, up=True))
                    ds //= 2
        assert not skips
        self.out_norm = NormSiLU(ch)
        self.out_conv = Conv(ch, in_channels * space_to_depth ** 2, 3,
                             torch.float32, zero=True)
        self._plan = plan

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        cdt = self.stem.dtype
        emb = timestep_embedding(t, self.base)
        emb = self.time_dense1(emb)
        emb = self.time_dense2(F.silu(emb))

        in_dtype = x.dtype
        h = x.to(cdt)
        if self.s2d > 1:
            h = _space_to_depth(h, self.s2d)
        h = self.stem(h)
        skips = [h]
        for step in self._plan:
            if step == "push":
                skips.append(h)
            elif step == "cat":
                h = torch.cat([h, skips.pop()], dim=1)
            else:
                block = getattr(self, step)
                h = block(h, emb) if isinstance(block, ResBlock) else block(h)
        h = self.out_norm(h.to(in_dtype))
        h = self.out_conv(h)
        if self.s2d > 1:
            h = _depth_to_space(h, self.s2d, self.in_channels)
        return h.float()


def _mults_from_args(mults) -> Tuple[int, ...]:
    if isinstance(mults, str):
        return tuple(int(s) for s in mults.replace(",", " ").split())
    if mults is None:
        return ()
    return tuple(int(m) for m in mults)


def unet_from_args(args, in_channels: int, dtype: torch.dtype = None) -> UNet:
    """Build the UNet from an args{N}.json config."""
    if dtype is None:
        dtype = _DTYPES[str(args.get("compute_dtype", "bfloat16") or "bfloat16")]
    img_size = args["img_size"]
    img_size = img_size[0] if isinstance(img_size, (tuple, list)) else int(img_size)
    return UNet(
        img_size=int(img_size),
        base_channels=int(args["base_channels"]),
        in_channels=in_channels,
        channel_mults=_mults_from_args(args.get("channel_mults", "")),
        dropout=float(args.get("dropout", 0) or 0),
        attention_resolutions=str(args.get("attention_resolutions") or "32,16,8"),
        n_heads=int(args.get("num_heads", 1) or 1),
        n_head_channels=int(args.get("num_head_channels", -1) or -1),
        space_to_depth=int(args.get("space_to_depth", 1) or 1),
        dtype=dtype,
    )
