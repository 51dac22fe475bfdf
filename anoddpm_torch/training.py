"""Training state, the train step and the multi-step.

Counterpart of `anoddpm_tpu/training.py:27-144`.  One step: draw t and the
noise, take the loss through the UNet, backpropagate (K2b at every
norm+SiLU site), clip the gradients' global norm as optax does, step
AdamW, and move the EMA.  The step queues its work on the card and returns
its metrics as tensors: nothing in it waits for the device.

Under a `parallel.Mesh` the UNet runs inside `DistributedDataParallel`,
which averages the gradients over the ranks before the clip (JAX clips
the global norm of the all-reduced gradient too).  `remat` recomputes the
UNet's forward in the backward (`torch.utils.checkpoint`), and
`make_multi_step` takes several steps per call.

Under `rng: "jax"` the generator is a `compat.jax_random.JaxKey` and a
step draws as the JAX package's does: `fold_in(key, step)`, split in
three (t, noise, dropout), t = `randint` and the simplex seeds `bits` of
those keys, made on the host and copied to the card from pinned memory
(no sync); a multi-step splits its key once per substep.  With a
loss-weight table t is `choice` of the table; with dropout, each
ResBlock's mask is flax's bernoulli from the dropout key folded with the
block's path.  So, as in JAX,
1 and 8 substeps per dispatch draw differently under a JaxKey, where a
torch.Generator passes through the same splits and fold-in as itself
(`streams`) and draws the same stream in the same order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, List, Mapping, Optional

import torch
import torch.nn as nn
from torch.utils import checkpoint as ckpt

from . import diffusion as dm
from . import streams
from .compat.flax_init import dropout_keys
from .models.ema import ema_update, init_ema
from .ops.noise import NoiseSampler
from .parallel.mesh import Mesh, data_parallel, shard_sampler
from .schedule import Schedule
from .streams import Stream

REMAT_POLICIES = (None, "dots", "nothing")
# jax.checkpoint_policies.dots_saveable keeps the outputs of dot_general
# and conv_general_dilated; these are the aten ops the UNet's convs, dense
# layers and attention matmuls reach.
_DOT_OPS = frozenset({torch.ops.aten.convolution.default,
                      torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})


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


def _dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


class Remat(nn.Module):
    """`model`'s forward under `torch.utils.checkpoint` (non-reentrant):
    "nothing" keeps only the inputs and recomputes the whole forward in the
    backward; "dots" keeps the outputs of the convolutions and matmuls and
    recomputes the rest (norms, K2, SiLU, adds, resampling).  K2 is an
    autograd Function whose launch the policy cannot see: in the recompute
    it launches again into a fresh tensor, which the backward then reads."""

    def __init__(self, model: nn.Module, policy: str):
        super().__init__()
        if policy not in ("dots", "nothing"):
            raise ValueError(f"remat must be one of {REMAT_POLICIES}, "
                             f"got {policy!r}")
        self.model = model
        self.policy = policy

    def forward(self, x, t):
        if self.policy == "dots":
            context_fn = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy)
        else:
            context_fn = ckpt.noop_context_fn
        return ckpt.checkpoint(self.model, x, t, use_reentrant=False,
                               context_fn=context_fn)


def make_train_step(sched: Schedule, noise_sampler: NoiseSampler,
                    loss_type: str = "l2", max_t: Optional[int] = None,
                    ema_decay: float = 0.9999, loss_weight: str = "none",
                    dropout: bool = False, remat: Optional[str] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """The train step `step(state, batch, generator, t=None)` ->
    {"loss", "grad_norm"} as tensors.

    batch: (B, C, H, W) on the model's device: this rank's rows of the
    global batch under a `mesh`, else the whole batch.  t ~ U[0, max_t)
    for the global batch from `generator` unless given (the tests inject
    the JAX package's draw); max_t = min(sample_distance, T) with
    train_start.  With a loss-weight table t is drawn from it and the loss
    importance-weighted.  The noise too is drawn for the global batch, and
    every rank keeps its rows, so that W ranks compute the loss of one;
    the loss returned is the global mean.  Dropout is on only when
    `dropout`: under a JaxKey each ResBlock's mask is flax's, from the
    step's dropout key (`compat.flax_init.dropout_keys`); under a
    torch.Generator it is `F.dropout`'s, from torch's global generator.
    `remat`: None,
    "dots" or "nothing" (`Remat`)."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {remat!r}")
    if max_t is None:
        max_t = sched.num_timesteps
    table = dm.make_loss_weights(loss_weight, sched.num_timesteps)
    sampler = shard_sampler(noise_sampler, mesh)
    net = net_model = None

    def forward_of(model: nn.Module) -> nn.Module:
        """The module the loss runs through: `model`, under `Remat` and
        DDP as asked, built at the first step.  A step serves one model."""
        nonlocal net, net_model
        if net is None:
            net = model if remat is None else Remat(model, remat)
            net = net if mesh is None else data_parallel(net, mesh)
            net_model = model
        elif net_model is not model:
            raise ValueError("this train step was built for another model")
        return net

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: Stream,
                   t: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        rows = slice(None)
        b = batch.shape[0]
        if mesh is not None:
            b *= mesh.world_size
            rows = mesh.rows(b)
        # the JAX step's t, noise and dropout keys; a torch.Generator is
        # all three
        t_key, noise_key, drop_key = streams.of(
            streams.of(generator).fold_in(state.step)).split(3)
        if dropout:
            state.model.dropout_streams = dropout_keys(state.model, drop_key)
        weights = None
        if table is not None:
            if t is None:
                t, weights = dm.sample_t_with_weights(t_key, b, table)
            else:
                p = table.to(t.device) / table.sum()
                weights = 1.0 / (table.shape[0] * p[t])
            weights = weights[rows]
        elif t is None:
            t = dm.sample_timesteps(t_key, b, max_t)
        t = t[rows]
        if state.model.training != dropout:
            state.model.train(dropout)
        per_sample, _ = dm.calc_loss(forward_of(state.model), sched, batch, t,
                                     noise_key, sampler, loss_type)
        loss = (per_sample.mean() if weights is None
                else (per_sample * weights).mean())
        state.optimizer.zero_grad()
        loss.backward()
        grad_norm = state.optimizer.step()
        ema_update(state.ema.parameters(), state.model.parameters(), ema_decay)
        state.step += 1
        loss = loss.detach() if mesh is None else mesh.mean(loss)
        return {"loss": loss, "grad_norm": grad_norm}

    return train_step


def make_multi_step(train_step: Callable, substeps: int) -> Callable:
    """`substeps` train steps per call, `multi(state, batches, generator,
    t=None)` on a (substeps, B, C, H, W) batch (t, when injected,
    (substeps, B)): step s takes batches[s] and its own draws.  Returns the
    mean loss and the mean grad_norm over the steps, as tensors, with no
    host sync (`anoddpm_tpu.training.make_multi_step`)."""

    def multi_step(state: TrainState, batches: torch.Tensor,
                   generator: Stream,
                   t: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if batches.shape[0] != substeps:
            raise ValueError(f"a multi-step of {substeps} got "
                             f"{batches.shape[0]} batches")
        losses, norms = [], []
        k = generator
        for s in range(substeps):
            k, sub = streams.of(k).split()
            m = train_step(state, batches[s], sub,
                           None if t is None else t[s])
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        return {"loss": torch.stack(losses).mean(),
                "grad_norm": torch.stack(norms).mean()}

    return multi_step
