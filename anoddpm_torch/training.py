"""Training state and the train step.

Counterpart of `anoddpm_tpu/training.py:27-119`.  One step: draw t and the
noise, take the loss through the UNet, backpropagate (K2b at every
norm+SiLU site), clip the gradients' global norm as optax does, step
AdamW, and move the EMA.  The step queues its work on the card and returns
its metrics as tensors: nothing in it waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Mapping, Optional

import torch
import torch.nn as nn

from . import diffusion as dm
from .models.ema import ema_update, init_ema
from .ops.noise import NoiseSampler
from .schedule import Schedule

_LATER = "is not ported yet (ROADMAP.md, Queue 1: {})"


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as one tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """optax.chain(clip_by_global_norm(max_norm), adamw(lr, b1=0.9, b2=0.999,
    eps=1e-8, weight_decay)) on torch: the gradients are divided by
    max(norm / max_norm, 1), which is optax's clip, then
    `torch.optim.AdamW` steps (fused on the card).  A parameter without a
    gradient takes a zero one, as under `jax.grad`."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float,
                 weight_decay: float = 0.0, grad_clip_norm: float = 1.0):
        self.params = list(params)
        self.max_norm = float(grad_clip_norm)
        fused = all(p.is_cuda for p in self.params)
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay,
                                       fused=fused or None)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip and step; returns the global norm before the clip."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        torch._foreach_div_(grads, torch.clamp(norm / self.max_norm, min=1.0))
        self.adamw.step()
        return norm


def make_optimizer(params: Iterable[nn.Parameter], lr: float,
                   weight_decay: float = 0.0,
                   grad_clip_norm: float = 1.0) -> Optimizer:
    """AdamW(lr, betas=(0.9, 0.999), eps=1e-8, wd) after a global-norm clip."""
    return Optimizer(params, lr, weight_decay, grad_clip_norm)


@dataclasses.dataclass
class TrainState:
    step: int               # steps taken in this run (host counter)
    model: nn.Module
    ema: nn.Module
    optimizer: Optimizer


def init_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    """The state of a fresh run: the EMA starts as a copy of the model."""
    return TrainState(step=0, model=model, ema=init_ema(model),
                      optimizer=optimizer)


def optimizer_state(state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    """AdamW's state by parameter name: {name: {"step", "exp_avg",
    "exp_avg_sq"}}; empty before the first step."""
    adamw = state.optimizer.adamw
    return {name: dict(adamw.state[p])
            for name, p in state.model.named_parameters() if p in adamw.state}


def load_optimizer_state(state: TrainState,
                         by_name: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
    """Restore AdamW's state from `optimizer_state`'s layout (or from
    `compat.flax_params.adamw_state_from_optax`)."""
    names = [name for name, _ in state.model.named_parameters()]
    missing = [n for n in names if n not in by_name]
    if missing:
        raise KeyError(f"optimizer state lacks {len(missing)} parameters, "
                       f"e.g. {missing[0]}")
    adamw = state.optimizer.adamw
    sd = adamw.state_dict()
    sd["state"] = {i: dict(by_name[n]) for i, n in enumerate(names)}
    adamw.load_state_dict(sd)


def make_train_step(sched: Schedule, noise_sampler: NoiseSampler,
                    loss_type: str = "l2", max_t: Optional[int] = None,
                    ema_decay: float = 0.9999, loss_weight: str = "none",
                    dropout: bool = False,
                    remat: Optional[str] = None) -> Callable:
    """The train step `step(state, batch, generator, t=None)` ->
    {"loss", "grad_norm"} as tensors.

    batch: (B, C, H, W) on the model's device.  t ~ U[0, max_t) from
    `generator` unless given (the tests inject the JAX package's draw);
    max_t = min(sample_distance, T) with train_start.  With a loss-weight
    table t is drawn from it and the loss importance-weighted.  Dropout is
    on only when `dropout` (it draws from torch's global generator)."""
    if remat is not None:
        raise NotImplementedError("remat " + _LATER.format("training, rest"))
    if max_t is None:
        max_t = sched.num_timesteps
    table = dm.make_loss_weights(loss_weight, sched.num_timesteps)

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: torch.Generator,
                   t: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        b = batch.shape[0]
        weights = None
        if table is not None:
            if t is None:
                t, weights = dm.sample_t_with_weights(generator, b, table)
            else:
                p = table.to(t.device) / table.sum()
                weights = 1.0 / (table.shape[0] * p[t])
        elif t is None:
            t = dm.sample_timesteps(generator, b, max_t)
        if state.model.training != dropout:
            state.model.train(dropout)
        per_sample, _ = dm.calc_loss(state.model, sched, batch, t, generator,
                                     noise_sampler, loss_type)
        loss = (per_sample.mean() if weights is None
                else (per_sample * weights).mean())
        state.optimizer.zero_grad()
        loss.backward()
        grad_norm = state.optimizer.step()
        ema_update(state.ema.parameters(), state.model.parameters(), ema_decay)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step
