"""The guided-diffusion UNet epsilon-predictor in plain fp32 PyTorch.

A frozen copy of the equations of `anoddpm_torch/models/unet.py` as the
benchmark was defined: ResBlocks with BigGAN-style in-block resampling, QKV
attention at the configured resolutions, a sinusoidal timestep embedding
with a 2-layer SiLU MLP, GroupNorm(32) (+ SiLU) as plain operations, and
space-to-depth.  NCHW.  The parameters carry the port's names, so one
state dict loads into both.

Every convolution, dense layer and attention product passes its operands
through `self.cast` first: the identity for the reference, a rounding to a
lower precision for the control (`quantize_fp8`).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# Per-resolution channel-multiplier defaults (reference UNet.py:239-251).
DEFAULT_CHANNEL_MULTS = {256: (1, 1, 2, 2, 4, 4), 128: (1, 1, 2, 3, 4),
                         64: (1, 2, 3, 4), 32: (1, 2, 3, 4)}
GROUPS = 32
EPS = 1e-5

Cast = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def quantize_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude at 448, e4m3's largest finite value), returned in fp32; the
    gradient passes through unrounded."""
    with torch.no_grad():
        scale = x.abs().amax().clamp(min=1e-30) / 448.0
        q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach() if x.requires_grad else q


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / half))
    angles = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def group_norm(x, gamma, beta):
    n, c = x.shape[:2]
    xg = x.reshape(n, GROUPS, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return y * gamma.view(shape) + beta.view(shape)


def silu(x):
    return x * torch.sigmoid(x)


class Norm(nn.Module):
    """GroupNorm(32), followed by SiLU when `act`.  `sites`, when a list,
    records (shape, where) of every norm+SiLU call: the port's K2 sites."""

    def __init__(self, channels: int, act: bool, where: str = "block"):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.act, self.where = act, where
        self.sites: Optional[List] = None

    def forward(self, x):
        if self.sites is not None and self.act:
            self.sites.append((tuple(x.shape), self.where))
        y = group_norm(x, self.weight, self.bias)
        return silu(y) if self.act else y


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, root):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.root = root

    def forward(self, x):
        c = self.root[0].cast
        return F.conv2d(c(x), c(self.weight), self.bias,
                        padding=self.weight.shape[-1] // 2)


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int, root):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.root = root

    def forward(self, x):
        c = self.root[0].cast
        return F.linear(c(x), c(self.weight), self.bias)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, time_dim, root, up=False, down=False):
        super().__init__()
        self.up, self.down = up, down
        self.norm_in = Norm(cin, True)
        self.conv_in = Conv(cin, cout, 3, root)
        self.emb_proj = Dense(time_dim, cout, root)
        self.norm_out = Norm(cout, True)
        self.conv_out = Conv(cout, cout, 3, root)
        self.skip = Conv(cin, cout, 1, root) if cin != cout else None

    def forward(self, x, emb):
        h = self.norm_in(x)
        if self.up:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif self.down:
            h = F.avg_pool2d(h, 2)
            x = F.avg_pool2d(x, 2)
        h = self.conv_in(h)
        h = h + self.emb_proj(silu(emb))[:, :, None, None]
        h = self.conv_out(self.norm_out(h))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Attention(nn.Module):
    """Self-attention over the H*W positions: per head, q, k and v are the
    three ch-wide thirds of the head's 3*ch qkv columns; q and k are each
    scaled by 1/sqrt(sqrt(ch)); softmax over the keys."""

    def __init__(self, channels: int, heads: int, root):
        super().__init__()
        self.heads = heads
        self.norm = Norm(channels, False)
        self.qkv = Dense(channels, 3 * channels, root)
        self.proj = Dense(channels, channels, root)
        self.root = root

    def forward(self, x):
        c_ = self.root[0].cast
        b, c, hgt, wid = x.shape
        ch = c // self.heads
        h = self.norm(x).reshape(b, c, hgt * wid).transpose(1, 2)
        qkv = self.qkv(h).reshape(b, hgt * wid, self.heads, 3 * ch)
        q, k, v = qkv.transpose(1, 2).split(ch, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        logits = torch.matmul(c_(q * scale), c_(k * scale).transpose(-1, -2))
        weights = torch.softmax(logits, dim=-1)
        attended = torch.matmul(c_(weights), c_(v)).transpose(1, 2)
        proj = self.proj(attended.reshape(b, hgt * wid, c))
        return x + proj.transpose(1, 2).reshape(b, c, hgt, wid)


def space_to_depth(x, s):
    b, c, hh, ww = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, hh // s, s, ww // s, s, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh // s, ww // s, s * s * c)
    return x.permute(0, 3, 1, 2)


def depth_to_space(x, s, c):
    b, _, hh, ww = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, hh, ww, s, s, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh * s, ww * s, c)
    return x.permute(0, 3, 1, 2)


class UNet(nn.Module):
    """eps(x, t): x (B, C, H, W) fp32, t (B,) int64 -> (B, C, H, W) fp32."""

    def __init__(self, img_size: int, base: int, in_channels: int = 1,
                 channel_mults: Sequence[int] = (), num_res_blocks: int = 2,
                 attention_resolutions: str = "16,8", heads: int = 2,
                 s2d: int = 1):
        super().__init__()
        self.cast: Cast = identity
        root = [self]       # a list, so that submodules do not register it
        self.in_channels, self.s2d, self.base = in_channels, s2d, base
        size = img_size // s2d
        mults = tuple(channel_mults) or DEFAULT_CHANNEL_MULTS[size]
        attention_ds = [size // max(int(r) // s2d, 1)
                        for r in str(attention_resolutions).split(",")]
        time_dim = base * 4
        self.time_dense1 = Dense(base, time_dim, root)
        self.time_dense2 = Dense(time_dim, time_dim, root)
        self.stem = Conv(in_channels * s2d ** 2, base, 3, root)
        plan = []

        def add(name, module):
            self.add_module(name, module)
            plan.append(name)

        ch, ds, skips = base, 1, [base]
        for i, mult in enumerate(mults):
            out_ch = int(base * mult)
            for j in range(num_res_blocks):
                add(f"down_{i}_{j}", ResBlock(ch, out_ch, time_dim, root))
                ch = out_ch
                if ds in attention_ds:
                    add(f"down_attn_{i}_{j}", Attention(ch, heads, root))
                skips.append(ch)
                plan.append("push")
            if i != len(mults) - 1:
                add(f"down_sample_{i}",
                    ResBlock(ch, ch, time_dim, root, down=True))
                ds *= 2
                skips.append(ch)
                plan.append("push")
        add("mid_res1", ResBlock(ch, ch, time_dim, root))
        add("mid_attn", Attention(ch, heads, root))
        add("mid_res2", ResBlock(ch, ch, time_dim, root))
        for i, mult in reversed(list(enumerate(mults))):
            out_ch = int(base * mult)
            for j in range(num_res_blocks + 1):
                plan.append("cat")
                add(f"up_{i}_{j}", ResBlock(ch + skips.pop(), out_ch,
                                            time_dim, root))
                ch = out_ch
                if ds in attention_ds:
                    add(f"up_attn_{i}_{j}", Attention(ch, heads, root))
                if i and j == num_res_blocks:
                    add(f"up_sample_{i}",
                        ResBlock(ch, ch, time_dim, root, up=True))
                    ds //= 2
        self.out_norm = Norm(ch, True, "out")
        self.out_conv = Conv(ch, in_channels * s2d ** 2, 3, root)
        self._plan = plan

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.base)
        emb = self.time_dense2(silu(self.time_dense1(emb)))
        h = space_to_depth(x, self.s2d) if self.s2d > 1 else x
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
        h = self.out_conv(self.out_norm(h))
        if self.s2d > 1:
            h = depth_to_space(h, self.s2d, self.in_channels)
        return h


def mults_of(value) -> Tuple[int, ...]:
    if isinstance(value, str):
        return tuple(int(s) for s in value.replace(",", " ").split())
    return tuple(int(m) for m in (value or ()))


def unet_of(cfg: dict) -> UNet:
    """The reference UNet of a benchmark configuration (the port's args
    keys), with zero parameters: `core.weights` fills them."""
    img = cfg["img_size"]
    img = int(img[0] if isinstance(img, (list, tuple)) else img)
    return UNet(img_size=img, base=int(cfg["base_channels"]),
                in_channels=1, channel_mults=mults_of(cfg.get("channel_mults")),
                attention_resolutions=str(cfg.get("attention_resolutions")
                                          or "32,16,8"),
                heads=int(cfg.get("num_heads", 1) or 1),
                s2d=int(cfg.get("space_to_depth", 1) or 1))


def norm_sites(cfg: dict, batch: int) -> List[Tuple[Tuple[int, ...], str]]:
    """(NCHW shape, where) of every norm+SiLU call of one forward at
    `batch`, in call order, traced on the meta device; `where` is "out" for
    the output norm, which the port runs on fp32 input, and "block" for the
    rest, which it runs in the compute dtype."""
    with torch.device("meta"):
        model = unet_of(cfg)
        size = cfg["img_size"]
        size = int(size[0] if isinstance(size, (list, tuple)) else size)
        x = torch.zeros((batch, 1, size, size))
        t = torch.zeros((batch,), dtype=torch.int64)
    sites: List = []
    for m in model.modules():
        if isinstance(m, Norm):
            m.sites = sites
    with torch.no_grad():
        model(x, t)
    return sites
