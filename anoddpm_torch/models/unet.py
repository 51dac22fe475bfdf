"""Guided-diffusion UNet epsilon-predictor as an `nn.Module`.

Mirrors `anoddpm_tpu/models/unet.py`: ResBlocks with BigGAN-style in-block
up/downsampling (or, with `biggan_updown=False`, a strided 3 x 3 conv down
and nearest x 2 then a 3 x 3 conv up), QKV attention at the configured
resolutions, a sinusoidal timestep embedding with a 2-layer SiLU MLP,
GroupNorm(32) with fp32 statistics, zero-initialised output projections,
optional 3 x 3 skip convs (`ResBlock(use_conv_skip=True)`) and optional
space-to-depth.
The layout is NCHW.

Submodules carry the flax tree's names (`down_0_0.norm_in`, `mid_attn.qkv`,
`out_conv`, ...), so converting flax parameters is a tree walk
(`anoddpm_torch.compat.flax_params`).

Precision mirrors flax's `dtype`: parameters are fp32; every conv and dense
casts its input and weight to the compute dtype; norms compute their
statistics in fp32 and return the activation dtype; `out_norm` and
`out_conv` run in fp32.

How the norms compute is the option `norm_impl`:

- "kernel" (the default): every norm+SiLU site calls kernel K2
  (`ops.group_norm_silu`) at every shape, and under autograd its gradient
  is kernel K2b; the attention norm (GroupNorm without SiLU, outside any
  kernel in the JAX package) is `F.group_norm` in fp32.  `bf16_norm` and
  `pallas_norm` change nothing here.
- "flax": the JAX package's own composition (`anoddpm_tpu/models/
  unet.py:48-83`): flax's GroupNorm order (`flax_norm`), rounded once to
  the activation dtype, then SiLU in that dtype, with JAX's gradients;
  `bf16_norm` is `GroupNorm32(bf16_path=...)`, which leaves the forward as
  it is and changes where the backward rounds.  A norm+SiLU site runs K2
  and K2b in their flax order (`ops.group_norm_silu_flax`; the plain
  composition on the CPU), the attention norm the composition in plain
  PyTorch.  With `pallas_norm`, a norm+SiLU site whose NHWC shape passes
  the TPU kernel's gate (`ops.group_norm_silu.eligible`) calls K2 in its
  own order instead, as the JAX package calls its Pallas kernel there.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import streams
from ..streams import Stream
from ..ops.group_norm_silu import (_FlaxSite, _flax_site, eligible,
                                   group_norm_silu, group_norm_silu_flax)

# Per-resolution channel-multiplier defaults (reference UNet.py:239-251).
DEFAULT_CHANNEL_MULTS = {
    512: (0.5, 1, 1, 2, 2, 4, 4),
    256: (1, 1, 2, 2, 4, 4),
    128: (1, 1, 2, 3, 4),
    64: (1, 2, 3, 4),
    32: (1, 2, 3, 4),
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NORM_IMPLS = ("kernel", "flax")


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of the timestep, [sin | cos] halves, fp32."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / half))
    angles = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# The standard deviation of a unit normal truncated at +-2.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """Flax's default kernel init, `lecun_normal`, in place: a normal
    truncated at +-2 standard deviations and scaled to variance 1/fan_in."""
    s = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=s, a=-2.0 * s, b=2.0 * s)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Flax/XLA "SAME" padding of one spatial axis: (low, high), the odd
    pixel on the high side (a 3 x 3 kernel at stride 2 on an even size
    pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Conv2d with 'SAME' padding whose input and weight are cast to the
    compute dtype (flax `nn.Conv(dtype=...)` with fp32 params).  At a
    stride above 1 the padding is applied explicitly, since flax's may be
    asymmetric."""

    def __init__(self, cin: int, cout: int, kernel: int, dtype: torch.dtype,
                 zero: bool = False, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype
        self.stride = stride
        self.zero = zero
        if zero:
            nn.init.zeros_(self.weight)
        else:
            lecun_normal_(self.weight, cin * kernel * kernel)

    def forward(self, x):
        w = self.weight
        x = x.to(self.dtype)
        k = w.shape[-1]
        if self.stride == 1:
            padding = k // 2
        else:
            padding = 0
            top, bottom = same_padding(x.shape[-2], k, self.stride)
            left, right = same_padding(x.shape[-1], k, self.stride)
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w.to(self.dtype), self.bias.to(self.dtype),
                        stride=self.stride, padding=padding)


class UpConv(Conv):
    """Nearest x 2 upsampling, then a 3 x 3 'SAME' conv (the up-sampling of
    `biggan_updown=False`)."""

    def forward(self, x):
        return super().forward(F.interpolate(x, scale_factor=2, mode="nearest"))


class Dense(nn.Module):
    """Linear layer computed in the compute dtype (flax `nn.Dense`)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype,
                 zero: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype
        self.zero = zero
        if zero:
            nn.init.zeros_(self.weight)
        else:
            lecun_normal_(self.weight, cin)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def flax_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              bf16_path: bool, silu: bool) -> torch.Tensor:
    """The JAX package's `GroupNorm32(bf16_path)` on NCHW x in x's dtype,
    followed by its SiLU when `silu`.  With SiLU, K2 in the flax order
    (`group_norm_silu_flax`: the kernel on the card, `_flax_site` on the
    CPU); without, `_flax_site` in plain PyTorch on either (the attention
    norm, outside any kernel in the JAX package too).  On the meta device,
    which carries shapes and no values (the FLOP counter's forward), both
    are `_flax_site`."""
    if silu and not x.is_meta:
        return group_norm_silu_flax(x, gamma, beta, bf16_path)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _FlaxSite.apply(x, gamma, beta, bf16_path, silu)
    return _flax_site(x, gamma, beta, bf16_path, silu)


class GroupNorm32(nn.Module):
    """GroupNorm(32) returned in the activation dtype: `F.group_norm` in
    fp32 under `norm_impl="kernel"`, the JAX package's composition
    (`flax_norm`, `bf16_norm` its bf16_path) under "flax"."""

    def __init__(self, channels: int, norm_impl: str = "kernel",
                 bf16_norm: bool = False):
        super().__init__()
        if norm_impl not in NORM_IMPLS:
            raise ValueError(f"norm_impl must be one of {NORM_IMPLS}, "
                             f"got {norm_impl!r}")
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.norm_impl = norm_impl
        self.bf16_norm = bf16_norm

    def forward(self, x):
        if self.norm_impl == "flax":
            return flax_norm(x, self.weight, self.bias, self.bf16_norm, False)
        return F.group_norm(x.float(), 32, self.weight, self.bias,
                            eps=1e-5).to(x.dtype)


class NormSiLU(GroupNorm32):
    """GroupNorm(32) + SiLU.  Kernel K2 under `norm_impl="kernel"`; under
    "flax", K2 where `pallas_norm` is set and the NHWC shape passes
    `eligible` (the JAX package's Pallas kernel), else K2 in the flax order
    (`flax_norm`)."""

    def __init__(self, channels: int, norm_impl: str = "kernel",
                 bf16_norm: bool = False, pallas_norm: bool = False):
        super().__init__(channels, norm_impl, bf16_norm)
        self.pallas_norm = pallas_norm

    def uses_kernel(self, x: torch.Tensor) -> bool:
        """Whether a call on x goes through K2 in the TPU kernel's order."""
        n, c, h, w = x.shape
        return self.norm_impl == "kernel" or (
            self.pallas_norm and eligible((n, h, w, c), x.dtype))

    def forward(self, x):
        if self.uses_kernel(x):
            return group_norm_silu(x, self.weight, self.bias)
        return flax_norm(x, self.weight, self.bias, self.bf16_norm, True)


class ResBlock(nn.Module):
    """Residual block with timestep-embedding injection and optional
    BigGAN-style in-block resampling."""

    def __init__(self, cin: int, cout: int, time_dim: int, dtype: torch.dtype,
                 dropout: float = 0.0, up: bool = False, down: bool = False,
                 use_conv_skip: bool = False, norm_impl: str = "kernel",
                 bf16_norm: bool = False, pallas_norm: bool = False):
        super().__init__()
        self.up, self.down, self.dropout = up, down, dropout
        norm = dict(norm_impl=norm_impl, bf16_norm=bf16_norm,
                    pallas_norm=pallas_norm)
        self.norm_in = NormSiLU(cin, **norm)
        self.conv_in = Conv(cin, cout, 3, dtype)
        self.emb_proj = Dense(time_dim, cout, dtype)
        self.norm_out = NormSiLU(cout, **norm)
        self.conv_out = Conv(cout, cout, 3, dtype, zero=True)
        self.skip = (Conv(cin, cout, 3 if use_conv_skip else 1, dtype)
                     if cin != cout else None)

    def forward(self, x, emb, dropout_stream=None):
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
        if self.training and dropout_stream is not None:
            h = streams.of(dropout_stream).dropout(h, self.dropout)
        else:
            h = F.dropout(h, self.dropout, self.training)
        h = self.conv_out(h)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over the H*W positions: q and k each scaled by
    1/sqrt(sqrt(ch)), softmax in fp32, as plain matmuls."""

    def __init__(self, channels: int, heads: int, dtype: torch.dtype,
                 norm_impl: str = "kernel", bf16_norm: bool = False):
        super().__init__()
        self.heads = heads
        self.norm = GroupNorm32(channels, norm_impl, bf16_norm)
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
                 space_to_depth: int = 1, dtype: torch.dtype = torch.float32,
                 biggan_updown: bool = True, norm_impl: str = "kernel",
                 bf16_norm: bool = False, pallas_norm: bool = False):
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

        norm = dict(norm_impl=norm_impl, bf16_norm=bf16_norm)
        res = lambda cin, cout, **kw: ResBlock(cin, cout, time_dim, dtype,
                                               dropout, pallas_norm=pallas_norm,
                                               **norm, **kw)
        attn = lambda c: AttentionBlock(c, heads_for(c), dtype, **norm)
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
                add(f"down_sample_{i}",
                    res(ch, ch, down=True) if biggan_updown
                    else Conv(ch, ch, 3, dtype, stride=2))
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
                    add(f"up_sample_{i}",
                        res(ch, ch, up=True) if biggan_updown
                        else UpConv(ch, ch, 3, dtype))
                    ds //= 2
        assert not skips
        self.out_norm = NormSiLU(ch, pallas_norm=pallas_norm, **norm)
        self.out_conv = Conv(ch, in_channels * space_to_depth ** 2, 3,
                             torch.float32, zero=True)
        self._plan = plan
        # each ResBlock's dropout stream by block name, set by the train
        # step (`compat.flax_init.dropout_keys`); empty: `F.dropout`
        self.dropout_streams: Dict[str, Stream] = {}

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
                h = (block(h, emb, self.dropout_streams.get(step))
                     if isinstance(block, ResBlock) else block(h))
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
    """Build the UNet from an args{N}.json config: the JAX package's keys,
    `bf16_norm` and `pallas_norm` among them, and the port's `norm_impl`
    ("kernel" unless the config says "flax"), which decides whether those
    two change anything."""
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
        norm_impl=str(args.get("norm_impl") or "kernel"),
        bf16_norm=bool(args.get("bf16_norm")),
        pallas_norm=bool(args.get("pallas_norm")),
    )
