"""Context-encoder inpainting baseline for the ROC comparisons.

Counterpart of `anoddpm_tpu/models/context_encoder.py:27-141`: an
encoder-decoder trained to inpaint masked patches of healthy images; at
detection time a sliding occlusion mask sweeps the image and the per-pixel
square error of the inpainted cells is the anomaly map.  The reference's
own context encoder (its Comparative_models/CE.py) is absent from its
repository; this is the JAX package's working baseline, in NCHW.

Flax details kept: GroupNorm(8) with epsilon 1e-6 in fp32 (stock
`F.group_norm`, not kernel K2: this norm has 8 groups), "SAME" padding
(for the 4 x 4 stride-2 convs (1, 1) on even sizes), and `jnp.repeat` x 2
as nearest upsampling.  The submodules `convs.i` and `norms.i` are flax's
auto-named `Conv_i` and `GroupNorm_i`, in creation order
(`compat.flax_params.context_encoder_state_dict_from_flax`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import streams
from ..compat.flax_init import jax_context_encoder_state_dict
from ..streams import Stream
from .unet import lecun_normal_, same_padding


class SameConv(nn.Module):
    """Conv2d with flax's "SAME" padding at any stride (padded explicitly,
    since `nn.Conv2d(padding=...)` pads both sides alike)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        lecun_normal_(self.weight, cin * kernel * kernel)

    def forward(self, x):
        k = self.weight.shape[-1]
        top, bottom = same_padding(x.shape[-2], k, self.stride)
        left, right = same_padding(x.shape[-1], k, self.stride)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, stride=self.stride)


class GroupNorm8(nn.Module):
    """flax `nn.GroupNorm(num_groups=8)`: epsilon 1e-6, fp32."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x.float(), 8, self.weight, self.bias, eps=1e-6)


class ContextEncoder(nn.Module):
    """Conv encoder-decoder: (masked image, mask) -> inpainted image, NCHW.

    forward(x (B, C, H, W), mask (B, 1, H, W)) keeps the visible pixels
    and fills the masked ones with the decoder's output."""

    def __init__(self, in_channels: int = 1, base_channels: int = 32,
                 levels: int = 3):
        super().__init__()
        self.levels = levels
        ch = base_channels
        convs, norms = [], []
        cin = in_channels + 1
        for i in range(levels):
            convs.append(SameConv(cin, ch * 2 ** i, 4, stride=2))
            norms.append(GroupNorm8(ch * 2 ** i))
            cin = ch * 2 ** i
        convs.append(SameConv(cin, ch * 2 ** levels, 3))
        cin = ch * 2 ** levels
        for i in reversed(range(levels)):
            convs.append(SameConv(cin + ch * 2 ** i, ch * 2 ** i, 3))
            norms.append(GroupNorm8(ch * 2 ** i))
            cin = ch * 2 ** i
        convs.append(SameConv(cin, in_channels, 3))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        visible = x * (1.0 - mask)
        h = torch.cat([visible, mask.expand(x.shape[0], 1, *x.shape[2:])], 1)
        skips = []
        for i in range(self.levels):
            h = F.silu(self.norms[i](self.convs[i](h)))
            skips.append(h)
        h = F.silu(self.convs[self.levels](h))
        for j, i in enumerate(reversed(range(self.levels))):
            h = torch.cat([h, skips[i]], 1)
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = F.silu(self.norms[self.levels + j](
                self.convs[self.levels + 1 + j](h)))
        out = self.convs[-1](h)
        return visible + out * mask


def random_box_mask(generator: Stream, shape: Tuple[int, ...],
                    frac: float = 0.25) -> torch.Tensor:
    """(B, 1, H, W) square occlusion masks, each side ~frac of the image's,
    at positions on the generator's device: the stream split in two, the
    rows drawn from the first and the columns from the second (JAX
    `models/context_encoder.py:60-68`)."""
    b, _, h, w = shape
    bh, bw = max(int(h * frac), 1), max(int(w * frac), 1)
    ky, kx = streams.of(generator).split()
    ys = streams.of(ky).randint((b,), h - bh + 1)
    xs = streams.of(kx).randint((b,), w - bw + 1)
    return _box(ys, xs, bh, bw, h, w)


def context_encoder_from_seed(args, seed: int, in_channels: int = 1,
                              base_channels: int = 32) -> ContextEncoder:
    """The baseline's initial weights from `seed`, on the CPU: under `rng:
    "jax"` flax's init of the JAX package's ContextEncoder at `key(seed)`
    (`compat.flax_init.jax_context_encoder_state_dict`), else lecun_normal
    from torch's global generator seeded `seed` (its state kept)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ContextEncoder(in_channels=in_channels,
                               base_channels=base_channels)
    if streams.rng_of(args) == "jax":
        model.load_state_dict(jax_context_encoder_state_dict(model, seed))
    return model


def _box(ys, xs, bh: int, bw: int, h: int, w: int) -> torch.Tensor:
    """(B, 1, H, W) fp32 masks of the boxes [ys, ys + bh) x [xs, xs + bw)."""
    yy = torch.arange(h, device=ys.device)[None, :, None]
    xx = torch.arange(w, device=ys.device)[None, None, :]
    ys, xs = ys[:, None, None], xs[:, None, None]
    m = (yy >= ys) & (yy < ys + bh) & (xx >= xs) & (xx < xs + bw)
    return m.to(torch.float32)[:, None]


def masked_l2(model: ContextEncoder, batch: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """The training loss: the mean square error over the masked pixels."""
    recon = model(batch, mask)
    return ((recon - batch) ** 2 * mask).sum() / (mask.sum() + 1e-6)


def make_ce_train_step(model: ContextEncoder, optimizer: torch.optim.Optimizer):
    """`step(batch, generator, mask=None)` -> loss: one optimizer step on
    the masked L2 loss, with a random box mask unless one is given."""

    def step(batch: torch.Tensor, generator: Stream,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            mask = random_box_mask(generator, batch.shape)
        loss = masked_l2(model, batch, mask)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _cells(images: torch.Tensor, window: int):
    """The `window` x `window` grid's cell masks, (1, 1, H, W) each."""
    _, _, h, w = images.shape
    step_h, step_w = h // window, w // window
    for idx in range(window * window):
        gy, gx = divmod(idx, window)
        ys = torch.full((1,), gy * step_h, device=images.device)
        xs = torch.full((1,), gx * step_w, device=images.device)
        yield _box(ys, xs, step_h, step_w, h, w)


@torch.no_grad()
def sliding_window_error(model: ContextEncoder, images: torch.Tensor,
                         window: int = 4) -> torch.Tensor:
    """The anomaly map: each cell of a `window` x `window` grid occluded in
    turn and inpainted, and the square error of each cell's
    reconstruction summed into (B, C, H, W)."""
    acc = torch.zeros_like(images)
    for mask in _cells(images, window):
        recon = model(images, mask)
        acc = acc + (recon - images) ** 2 * mask
    return acc


@torch.no_grad()
def sliding_window_inpaint(model: ContextEncoder, images: torch.Tensor,
                           window: int = 4) -> torch.Tensor:
    """The full-image reconstruction: each grid cell occluded in turn and
    replaced by its inpainted content (the figure sheets' panel)."""
    acc = images
    for mask in _cells(images, window):
        recon = model(images, mask)
        acc = acc * (1.0 - mask) + recon * mask
    return acc
