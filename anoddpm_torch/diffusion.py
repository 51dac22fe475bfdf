"""The diffusion process on the detection path: q/p distributions and the
partial forward-backward primitive, as plain functions on tensors.

Counterpart of `anoddpm_tpu/diffusion.py:35-217`.  Every function takes the
`Schedule` and a `model_fn(x, t) -> eps`; tensors are NCHW and timesteps a
(B,) int64 tensor.  The reverse chain is a Python loop with no host syncs;
its noise comes from the sampler and an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .ops.noise import NoiseSampler, gaussian_noise
from .schedule import Schedule

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] reshaped to broadcast against an ndim tensor."""
    return a[t].reshape(t.shape + (1,) * (ndim - 1))


def sample_q(sched: Schedule, x_0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0) one-jump sample."""
    return (extract(sched.sqrt_alphas_cumprod, t, x_0.dim()) * x_0
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, x_0.dim()) * noise)


def q_posterior_mean_variance(sched: Schedule, x_0: torch.Tensor,
                              x_t: torch.Tensor, t: torch.Tensor):
    """Posterior q(x_{t-1} | x_t, x_0): (mean, variance, log variance)."""
    n = x_t.dim()
    mean = (extract(sched.posterior_mean_coef1, t, n) * x_0
            + extract(sched.posterior_mean_coef2, t, n) * x_t)
    return (mean, extract(sched.posterior_variance, t, n),
            extract(sched.posterior_log_variance_clipped, t, n))


def predict_x0_from_eps(sched: Schedule, x_t: torch.Tensor, t: torch.Tensor,
                        eps: torch.Tensor) -> torch.Tensor:
    return (extract(sched.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t
            - extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.dim()) * eps)


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_x_0: torch.Tensor


def p_mean_variance(model_fn: ModelFn, sched: Schedule, x_t: torch.Tensor,
                    t: torch.Tensor,
                    estimate_noise: Optional[torch.Tensor] = None) -> PMeanVariance:
    """p(x_{t-1} | x_t) with the fixed model variance
    append(posterior_var[1], betas[1:]) and x0 clamped to [-1, 1]."""
    if estimate_noise is None:
        estimate_noise = model_fn(x_t, t)
    n = x_t.dim()
    pred_x_0 = torch.clamp(predict_x0_from_eps(sched, x_t, t, estimate_noise),
                           -1.0, 1.0)
    mean, _, _ = q_posterior_mean_variance(sched, pred_x_0, x_t, t)
    return PMeanVariance(mean, extract(sched.model_variance, t, n),
                         extract(sched.model_log_variance, t, n), pred_x_0)


def sample_p(model_fn: ModelFn, sched: Schedule, x_t: torch.Tensor,
             t: torch.Tensor, generator: torch.Generator,
             noise_sampler: NoiseSampler = gaussian_noise):
    """One reverse step x_t -> x_{t-1}; returns (sample, pred_x_0).  Noise
    is drawn at every step and zeroed where t == 0."""
    out = p_mean_variance(model_fn, sched, x_t, t)
    noise = noise_sampler(x_t.shape, t, generator)
    nonzero = (t != 0).to(x_t.dtype).reshape(t.shape + (1,) * (x_t.dim() - 1))
    return out.mean + nonzero * torch.exp(0.5 * out.log_variance) * noise, out.pred_x_0


def denoise_chain(model_fn: ModelFn, sched: Schedule, x: torch.Tensor,
                  t_distance: int, generator: torch.Generator,
                  noise_sampler: NoiseSampler = gaussian_noise) -> torch.Tensor:
    """Reverse chain t = t_distance-1 .. 0."""
    for t in range(t_distance - 1, -1, -1):
        t_batch = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        x, _ = sample_p(model_fn, sched, x, t_batch, generator, noise_sampler)
    return x


def forward_backward(model_fn: ModelFn, sched: Schedule, x: torch.Tensor,
                     t_distance: Optional[int], generator: torch.Generator,
                     noise_sampler: NoiseSampler = gaussian_noise,
                     denoise_sampler: Optional[NoiseSampler] = None) -> torch.Tensor:
    """The anomaly-detection primitive, partial diffusion: one q-jump of x_0
    to t_distance - 1 with `noise_sampler`, then t_distance reverse steps
    with `denoise_sampler` (by default the same).  Returns x_recon."""
    if t_distance == 0:
        return x
    if t_distance is None:
        t_distance = sched.num_timesteps
    if denoise_sampler is None:
        denoise_sampler = noise_sampler
    t_batch = torch.full((x.shape[0],), t_distance - 1, dtype=torch.int64,
                         device=x.device)
    x_t = sample_q(sched, x, t_batch, noise_sampler(x.shape, t_batch, generator))
    return denoise_chain(model_fn, sched, x_t, t_distance, generator,
                         denoise_sampler)
