"""The train step in plain fp32: t and the simplex noise, the l2 loss on
the UNet's eps, the backward, the global-norm clip, AdamW and the EMA.

A frozen copy of the equations of `anoddpm_torch/training.py`
(`make_train_step`, `Optimizer`: optax's clip then AdamW with betas (0.9,
0.999) and eps 1e-8) and `models/ema.py`, as the benchmark was defined.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import diffusion as rd

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def max_t(cfg: dict) -> int:
    """t ~ U[0, max_t): min(sample_distance, T) with train_start."""
    if cfg.get("train_start"):
        return min(int(cfg["sample_distance"]), int(cfg["T"]))
    return int(cfg["T"])


class State:
    """Parameters, their EMA and AdamW's moments, by name, fp32."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.ema = [p.detach().clone() for p in self.params]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.step = 0


def train_step(state: State, s, cfg: dict, x0: torch.Tensor,
               draws: rd.Draws, half_batch: bool = False) -> Dict[str, object]:
    """One step; returns the loss and the gradients as AdamW takes them
    (after the clip).  `half_batch` is a fault for the checks: the loss is
    the mean over the first half of the rows alone."""
    b = x0.shape[0]
    t = draws.randint(b, max_t(cfg))
    noise = rd.simplex(cfg, x0.shape, t, draws)
    x_t = rd.sample_q(s, x0, t, noise)
    for p in state.params:
        p.grad = None
    eps = state.model(x_t, t)
    per_sample = ((eps - noise) ** 2).mean(dim=(1, 2, 3))
    loss = per_sample[: b // 2].mean() if half_batch else per_sample.mean()
    loss.backward()
    grads: List[torch.Tensor] = [p.grad if p.grad is not None
                                 else torch.zeros_like(p) for p in state.params]
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    clip = torch.clamp(norm / float(cfg.get("grad_clip_norm", 1.0) or 1.0), min=1.0)
    grads = [g / clip for g in grads]
    lr = float(cfg["lr"])
    wd = float(cfg.get("weight_decay", 0) or 0)
    decay = float(cfg.get("ema_decay", 0.9999) or 0.9999)
    state.step += 1
    c1 = 1.0 - BETAS[0] ** state.step
    c2 = 1.0 - BETAS[1] ** state.step
    with torch.no_grad():
        for p, g, m, v, e in zip(state.params, grads, state.m, state.v,
                                 state.ema):
            p.mul_(1.0 - lr * wd)
            m.mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
            v.mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS))
            e.mul_(decay).add_(p, alpha=1.0 - decay)
    return {"loss": loss.detach(), "grads": grads}
