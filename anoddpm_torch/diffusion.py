"""The diffusion process: q/p distributions, the partial forward-backward
primitive, and the training objective with its likelihood terms, as plain
functions on tensors.

Counterpart of `anoddpm_tpu/diffusion.py:35-217` (detection) and
`:361-502` (losses, VLB, timestep sampling).  Every function takes the
`Schedule` and a `model_fn(x, t) -> eps`; tensors are NCHW and timesteps a
(B,) int64 tensor.  The reverse chain and the VLB sweep are Python loops
with no host syncs; their noise comes from a sampler and an explicit
`torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from .ops.noise import NoiseSampler, gaussian_noise
from .schedule import Schedule

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] reshaped to broadcast against an ndim tensor."""
    return a[t].reshape(t.shape + (1,) * (ndim - 1))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dimensions."""
    return x.mean(dim=tuple(range(1, x.dim())))


def sample_q(sched: Schedule, x_0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0) one-jump sample."""
    return (extract(sched.sqrt_alphas_cumprod, t, x_0.dim()) * x_0
            + extract(sched.sqrt_one_minus_alphas_cumprod, t, x_0.dim()) * noise)


def q_mean_variance(sched: Schedule, x_0: torch.Tensor, t: torch.Tensor):
    """Mean, variance and log variance of q(x_t | x_0)."""
    n = x_0.dim()
    return (extract(sched.sqrt_alphas_cumprod, t, n) * x_0,
            extract(1.0 - sched.alphas_cumprod, t, n),
            extract(sched.log_one_minus_alphas_cumprod, t, n))


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


def predict_eps_from_x0(sched: Schedule, x_t: torch.Tensor, t: torch.Tensor,
                        pred_x_0: torch.Tensor) -> torch.Tensor:
    return ((extract(sched.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t
             - pred_x_0)
            / extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.dim()))


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


# Likelihoods and losses (anoddpm_tpu/diffusion.py:361-502)

def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)) in nats; any argument
    may be a Python float."""
    ref = next(a for a in (mean1, logvar1, mean2, logvar2)
               if isinstance(a, torch.Tensor))
    mean1, logvar1, mean2, logvar2 = (
        torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
        for a in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretised_gaussian_log_likelihood(x: torch.Tensor, means: torch.Tensor,
                                        log_scales: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretised to the +-1/255 bins of an
    image in [-1, 1]."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))


def calc_vlb_xt(model_fn: ModelFn, sched: Schedule, x_0: torch.Tensor,
                x_t: torch.Tensor, t: torch.Tensor,
                estimate_noise: Optional[torch.Tensor] = None):
    """Per-timestep VLB term in bits, (B,): KL(q || p) at t > 0, the
    discretised decoder NLL at t = 0; and the clamped pred_x_0."""
    true_mean, _, true_log_var = q_posterior_mean_variance(sched, x_0, x_t, t)
    out = p_mean_variance(model_fn, sched, x_t, t, estimate_noise)
    kl = mean_flat(normal_kl(true_mean, true_log_var, out.mean,
                             out.log_variance)) / math.log(2.0)
    decoder_nll = -discretised_gaussian_log_likelihood(
        x_0, out.mean, log_scales=0.5 * out.log_variance)
    decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
    return torch.where(t == 0, decoder_nll, kl), out.pred_x_0


def prior_vlb(sched: Schedule, x_0: torch.Tensor) -> torch.Tensor:
    """KL(q(x_T | x_0) || N(0, I)) in bits, (B,)."""
    t = torch.full((x_0.shape[0],), sched.num_timesteps - 1, dtype=torch.int64,
                   device=x_0.device)
    qt_mean, _, qt_log_variance = q_mean_variance(sched, x_0, t)
    return mean_flat(normal_kl(qt_mean, qt_log_variance, 0.0, 0.0)) / math.log(2.0)


def calc_loss(model_fn: ModelFn, sched: Schedule, x_0: torch.Tensor,
              t: torch.Tensor, generator: torch.Generator,
              noise_sampler: NoiseSampler = gaussian_noise,
              loss_type: str = "l2"):
    """The training objective: (per-sample loss (B,), {"x_t", "estimate",
    "noise"}).  "l1" and "l2" compare the model's eps with the noise;
    "hybrid" adds the VLB term; any other name is l2, as in the reference."""
    noise = noise_sampler(x_0.shape, t, generator)
    x_t = sample_q(sched, x_0, t, noise)
    estimate = model_fn(x_t, t)
    if loss_type == "l1":
        loss = mean_flat((estimate - noise).abs())
    elif loss_type == "hybrid":
        vlb, _ = calc_vlb_xt(model_fn, sched, x_0, x_t, t, estimate)
        loss = vlb + mean_flat((estimate - noise) ** 2)
    else:
        loss = mean_flat((estimate - noise) ** 2)
    return loss, {"x_t": x_t, "estimate": estimate, "noise": noise}


def sample_timesteps(generator: torch.Generator, batch: int,
                     max_t: int) -> torch.Tensor:
    """Uniform t ~ U[0, max_t) on the generator's device.  With train_start
    the caller passes max_t = min(sample_distance, T), so that the model
    never trains on t >= lambda_max (deliberate, as in the reference)."""
    return torch.randint(0, max_t, (batch,), generator=generator,
                         device=generator.device)


def make_loss_weights(loss_weight: str, num_timesteps: int):
    """Importance-sampling weight table over t, or None for uniform t."""
    if loss_weight == "prop-t":
        return torch.arange(num_timesteps, 0, -1, dtype=torch.float32)
    if loss_weight == "uniform":
        return torch.ones((num_timesteps,), dtype=torch.float32)
    return None


def sample_t_with_weights(generator: torch.Generator, batch: int,
                          weight_table: torch.Tensor):
    """t drawn with probability p[t] = w[t] / sum(w), and its importance
    weight 1 / (N p[t]).

    Deliberate deviation kept from the JAX package: the textbook weight
    1 / (N p[t]), where the reference computes (1 / N) p[t], which scales
    the loss by about p^2 N^2 against the unbiased estimator.  No shipped
    config sets loss_weight, so shipped behaviour is the same."""
    weight_table = weight_table.to(generator.device)
    p = weight_table / weight_table.sum()
    t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (weight_table.shape[0] * p[t])


def calc_total_vlb(model_fn: ModelFn, sched: Schedule, x_0: torch.Tensor,
                   generator: torch.Generator,
                   noise_sampler: NoiseSampler = gaussian_noise
                   ) -> Dict[str, torch.Tensor]:
    """The full T-step VLB sweep, a Python loop over t = T-1 .. 0 with no
    host syncs; the noise of each step is Gaussian (`noise_sampler` is for
    tests that inject it).

    Returns total_vlb and prior_vlb, (B,), and vb, x_0_mse and mse, (B, T),
    ordered by descending t (column i is t = T-1-i)."""
    vb, x0_mse, mse = [], [], []
    for t in range(sched.num_timesteps - 1, -1, -1):
        t_batch = torch.full((x_0.shape[0],), t, dtype=torch.int64,
                             device=x_0.device)
        noise = noise_sampler(x_0.shape, t_batch, generator).to(x_0.dtype)
        x_t = sample_q(sched, x_0, t_batch, noise)
        term, pred_x_0 = calc_vlb_xt(model_fn, sched, x_0, x_t, t_batch)
        vb.append(term)
        x0_mse.append(mean_flat((pred_x_0 - x_0) ** 2))
        eps = predict_eps_from_x0(sched, x_t, t_batch, pred_x_0)
        mse.append(mean_flat((eps - noise) ** 2))
    vb = torch.stack(vb, dim=1)
    p_vlb = prior_vlb(sched, x_0)
    return {"total_vlb": vb.sum(dim=1) + p_vlb, "prior_vlb": p_vlb, "vb": vb,
            "x_0_mse": torch.stack(x0_mse, dim=1),
            "mse": torch.stack(mse, dim=1)}
