"""The diffusion process: q/p distributions, the partial forward-backward
primitive with its frame capture, the batched-lambda chain, DDIM, and the
training objective with its likelihood terms, as plain functions on tensors.

Counterpart of `anoddpm_tpu/diffusion.py:35-354` (detection, DDIM) and
`:361-502` (losses, VLB, timestep sampling).  Every function takes the
`Schedule` and a `model_fn(x, t) -> eps`; tensors are NCHW and timesteps a
(B,) int64 tensor.  The chains and the VLB sweep are Python loops with no
host syncs; their noise comes from a sampler and an explicit
`torch.Generator`, drawn in the order the steps run: the forward jump (or
the forward chain's steps) first, then one field per reverse step.  Each
takes a `compat.jax_random.JaxKey` in the generator's place too (config key
`rng: "jax"`): then every function splits it where its counterpart in the
JAX package splits its key (`streams.of(...).split`: a forward and a
reverse key, one split per chain step, per VLB step), so that its draws
are the JAX package's.  A torch.Generator passes through those splits as
itself, drawing in the same order as before.

Frame capture: a chain given a list as `frames` appends every x it
produces, on the device; `forward_backward_sequence` stacks them once into
the (F, B, C, H, W) tensor that the JAX `forward_backward(...,
see_whole_sequence=...)` returns beside x.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from . import streams
from .ops.noise import NoiseSampler, gaussian_noise
from .schedule import Schedule
from .streams import Stream

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


def sample_q_gradual(sched: Schedule, x_t: torch.Tensor, t: torch.Tensor,
                     noise: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_{t-1}) single-step sample."""
    return (extract(sched.sqrt_alphas, t, x_t.dim()) * x_t
            + extract(sched.sqrt_betas, t, x_t.dim()) * noise)


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
             t: torch.Tensor, generator: Stream,
             noise_sampler: NoiseSampler = gaussian_noise):
    """One reverse step x_t -> x_{t-1}; returns (sample, pred_x_0).  Noise
    is drawn at every step and zeroed where t == 0."""
    out = p_mean_variance(model_fn, sched, x_t, t)
    noise = noise_sampler(x_t.shape, t, generator)
    nonzero = (t != 0).to(x_t.dtype).reshape(t.shape + (1,) * (x_t.dim() - 1))
    return out.mean + nonzero * torch.exp(0.5 * out.log_variance) * noise, out.pred_x_0


def _full(x: torch.Tensor, t: int) -> torch.Tensor:
    return torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)


def denoise_chain(model_fn: ModelFn, sched: Schedule, x: torch.Tensor,
                  t_distance: int, generator: Stream,
                  noise_sampler: NoiseSampler = gaussian_noise,
                  frames: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Reverse chain t = t_distance-1 .. 0; appends each step's x to
    `frames` when given."""
    k = generator
    for t in range(t_distance - 1, -1, -1):
        k, sub = streams.of(k).split()
        x, _ = sample_p(model_fn, sched, x, _full(x, t), sub, noise_sampler)
        if frames is not None:
            frames.append(x)
    return x


def diffuse_gradual_chain(sched: Schedule, x: torch.Tensor, t_distance: int,
                          generator: Stream,
                          noise_sampler: NoiseSampler = gaussian_noise,
                          frames: Optional[List[torch.Tensor]] = None
                          ) -> torch.Tensor:
    """Forward chain of single q-steps t = 0 .. t_distance-1, one noise field
    per step ("whole" mode); appends each step's x to `frames` when
    given."""
    k = generator
    for t in range(t_distance):
        k, sub = streams.of(k).split()
        t_batch = _full(x, t)
        x = sample_q_gradual(sched, x, t_batch,
                             noise_sampler(x.shape, t_batch, sub))
        if frames is not None:
            frames.append(x)
    return x


def forward_backward(model_fn: ModelFn, sched: Schedule, x: torch.Tensor,
                     t_distance: Optional[int], generator: Stream,
                     noise_sampler: NoiseSampler = gaussian_noise,
                     denoise_sampler: Optional[NoiseSampler] = None,
                     gradual_forward: bool = False,
                     frames: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The anomaly-detection primitive, partial diffusion: one q-jump of x_0
    to t_distance - 1 with `noise_sampler` (or, with `gradual_forward`,
    t_distance single q-steps), then t_distance reverse steps with
    `denoise_sampler` (by default the same).  Returns x_recon; appends the
    forward frames (the jump's x_t alone, or every forward step) and every
    reverse step to `frames` when given."""
    if t_distance == 0:
        return x
    if t_distance is None:
        t_distance = sched.num_timesteps
    if denoise_sampler is None:
        denoise_sampler = noise_sampler
    key_fwd, key_rev = streams.of(generator).split()
    if gradual_forward:
        x_t = diffuse_gradual_chain(sched, x, t_distance, key_fwd,
                                    noise_sampler, frames)
    else:
        t_batch = _full(x, t_distance - 1)
        x_t = sample_q(sched, x, t_batch,
                       noise_sampler(x.shape, t_batch, key_fwd))
        if frames is not None:
            frames.append(x_t)
    return denoise_chain(model_fn, sched, x_t, t_distance, key_rev,
                         denoise_sampler, frames)


def forward_backward_sequence(model_fn: ModelFn, sched: Schedule,
                              x: torch.Tensor, t_distance: Optional[int],
                              generator: Stream,
                              noise_sampler: NoiseSampler = gaussian_noise,
                              denoise_sampler: Optional[NoiseSampler] = None,
                              see_whole_sequence: str = "half"):
    """`forward_backward` with its frames: (x_recon, frames), frames an
    (F, B, C, H, W) tensor on x's device, or None when t_distance is 0.
    The counterpart of the JAX `forward_backward(...,
    see_whole_sequence=...)` and its `(x, frames)`: "half" gives [x_lambda,
    the reverse chain], "whole" runs the gradual forward chain and gives
    [the forward chain, the reverse chain]."""
    if see_whole_sequence not in ("half", "whole"):
        raise ValueError(f"see_whole_sequence must be 'half' or 'whole', got "
                         f"{see_whole_sequence!r}")
    frames: List[torch.Tensor] = []
    x_recon = forward_backward(model_fn, sched, x, t_distance, generator,
                               noise_sampler, denoise_sampler,
                               gradual_forward=see_whole_sequence == "whole",
                               frames=frames)
    return x_recon, (torch.stack(frames) if frames else None)


def forward_backward_batched_lambda(model_fn: ModelFn, sched: Schedule,
                                    x: torch.Tensor, lam: torch.Tensor,
                                    max_t: int, generator: Stream,
                                    noise_sampler: NoiseSampler = gaussian_noise,
                                    denoise_sampler: Optional[NoiseSampler] = None
                                    ) -> torch.Tensor:
    """Partial diffusion with a per-sample depth: sample i is q-jumped to
    lam[i] - 1 and then updated only at the reverse steps t < lam[i] of one
    masked chain of `max_t` steps; lam[i] == 0 returns sample i unchanged.

    The noise is drawn in `forward_backward`'s order (the q-jump field at
    the per-sample t, then one field per reverse step), so with every
    lam[i] == max_t the result is the tensor that
    `forward_backward(t_distance=max_t)` gives from the same generator
    state."""
    if denoise_sampler is None:
        denoise_sampler = noise_sampler
    lam = torch.as_tensor(lam, dtype=torch.int64, device=x.device)
    bcast = (x.shape[0],) + (1,) * (x.dim() - 1)
    key_fwd, k = streams.of(generator).split()
    t_corrupt = torch.clamp(lam - 1, min=0)
    x_corrupt = sample_q(sched, x, t_corrupt,
                         noise_sampler(x.shape, t_corrupt, key_fwd))
    xc = torch.where((lam > 0).view(bcast), x_corrupt, x)
    for t in range(max_t - 1, -1, -1):
        k, sub = streams.of(k).split()
        x_next, _ = sample_p(model_fn, sched, xc, _full(x, t), sub,
                             denoise_sampler)
        xc = torch.where((t < lam).view(bcast), x_next, xc)
    return xc


# DDIM (Song et al., arXiv:2010.02502): the lambda-step reverse chain
# replaced by S strided steps (anoddpm_tpu/diffusion.py:267-354).

def ddim_step(sched: Schedule, x_t: torch.Tensor, t: torch.Tensor,
              t_prev: torch.Tensor, eps: torch.Tensor, eta: float = 0.0,
              noise: Optional[torch.Tensor] = None):
    """One DDIM update x_t -> x_{t_prev} from the model's eps; t_prev == -1
    is the terminal step to x_0 (alpha_bar_prev = 1).  Returns (x_prev,
    pred_x0)."""
    n = x_t.dim()
    acp_t = extract(sched.alphas_cumprod, t, n)
    acp_prev = torch.where(
        (t_prev < 0).reshape(t_prev.shape + (1,) * (n - 1)),
        torch.ones((), dtype=acp_t.dtype, device=acp_t.device),
        extract(sched.alphas_cumprod, torch.clamp(t_prev, min=0), n))
    pred_x0 = torch.clamp((x_t - torch.sqrt(1.0 - acp_t) * eps)
                          / torch.sqrt(acp_t), -1.0, 1.0)
    # eps re-derived from the clamped x0, so that the update stays consistent
    eps_hat = (x_t - torch.sqrt(acp_t) * pred_x0) / torch.sqrt(1.0 - acp_t)
    sigma = (eta * torch.sqrt((1.0 - acp_prev) / (1.0 - acp_t))
             * torch.sqrt(1.0 - acp_t / acp_prev))
    dir_xt = torch.sqrt(torch.clamp(1.0 - acp_prev - sigma ** 2, min=0.0)) * eps_hat
    x_prev = torch.sqrt(acp_prev) * pred_x0 + dir_xt
    if noise is not None:
        x_prev = x_prev + sigma * noise
    return x_prev, pred_x0


def ddim_timesteps(t_distance: int, num_steps: int) -> torch.Tensor:
    """The descending strided subsequence of [0, t_distance): S evenly
    spaced timesteps ending at 0, as int64 on the host.

    The grid is the JAX package's `jnp.linspace(0, t_distance - 1, S)` as
    XLA evaluates it in fp32 (the step (t_distance - 1) * (1 / div) rounded
    first, then times i; the last value is the stop itself), rounded half
    to even as `jnp.round` and `torch.round` both do.  Exact arithmetic
    would round some grid values to the other side of a half (13 * 5/10 =
    6.5 -> 6, where XLA's 6.5000005 -> 7)."""
    num_steps = min(num_steps, t_distance)
    div = num_steps - 1
    if div < 1:
        return torch.zeros((max(num_steps, 0),), dtype=torch.int64)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    stop = f32(float(t_distance - 1))
    step = stop * (f32(1.0) / f32(float(div)))
    grid = torch.cat([step * torch.arange(div, dtype=torch.float32),
                      stop.view(1)])
    return torch.round(grid).to(torch.int64).flip(0)


def ddim_chain(model_fn: ModelFn, sched: Schedule, x: torch.Tensor,
               t_distance: int, num_steps: int, generator: Stream,
               eta: float = 0.0, noise_sampler: NoiseSampler = gaussian_noise,
               frames: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Strided reverse chain x_{t_distance-1} -> x_0 in `num_steps` model
    evaluations; a noise field is drawn at each step only when eta > 0.
    Appends each step's x to `frames` when given."""
    ts = ddim_timesteps(t_distance, num_steps).tolist()
    k = generator
    for t, t_prev in zip(ts, ts[1:] + [-1]):
        k, sub = streams.of(k).split()
        t_batch = _full(x, t)
        eps = model_fn(x, t_batch)
        noise = noise_sampler(x.shape, t_batch, sub) if eta > 0 else None
        x, _ = ddim_step(sched, x, t_batch, _full(x, t_prev), eps, eta, noise)
        if frames is not None:
            frames.append(x)
    return x


def forward_backward_ddim(model_fn: ModelFn, sched: Schedule, x: torch.Tensor,
                          t_distance: int, num_steps: int,
                          generator: Stream,
                          noise_sampler: NoiseSampler = gaussian_noise,
                          eta: float = 0.0,
                          frames: Optional[List[torch.Tensor]] = None
                          ) -> torch.Tensor:
    """Partial diffusion with a DDIM reverse chain: one q-jump to
    t_distance - 1, then `num_steps` strided steps.  Returns x_recon;
    appends x_t and every step's x to `frames` when given (the JAX
    `see_whole_sequence` frames)."""
    if t_distance == 0:
        return x
    key_fwd, key_rev = streams.of(generator).split()
    t_batch = _full(x, t_distance - 1)
    x_t = sample_q(sched, x, t_batch, noise_sampler(x.shape, t_batch, key_fwd))
    if frames is not None:
        frames.append(x_t)
    return ddim_chain(model_fn, sched, x_t, t_distance, num_steps, key_rev,
                      eta, noise_sampler, frames)


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
              t: torch.Tensor, generator: Stream,
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


def sample_timesteps(generator: Stream, batch: int,
                     max_t: int) -> torch.Tensor:
    """Uniform t ~ U[0, max_t) on the generator's device.  With train_start
    the caller passes max_t = min(sample_distance, T), so that the model
    never trains on t >= lambda_max (deliberate, as in the reference).  A
    JaxKey's `randint` is drawn on the host and copied."""
    return streams.of(generator).randint((batch,), max_t)


def make_loss_weights(loss_weight: str, num_timesteps: int):
    """Importance-sampling weight table over t, or None for uniform t."""
    if loss_weight == "prop-t":
        return torch.arange(num_timesteps, 0, -1, dtype=torch.float32)
    if loss_weight == "uniform":
        return torch.ones((num_timesteps,), dtype=torch.float32)
    return None


def sample_t_with_weights(generator: Stream, batch: int,
                          weight_table: torch.Tensor):
    """t drawn with probability p[t] = w[t] / sum(w) from the host table w,
    and its importance weight 1 / (N p[t]), both on the generator's device.
    Under a JaxKey t is `jax.random.choice(key, N, (batch,), p=p)`, made
    on the host and copied (`anoddpm_tpu/diffusion.py:453-466`).

    Deliberate deviation kept from the JAX package: the textbook weight
    1 / (N p[t]), where the reference computes (1 / N) p[t], which scales
    the loss by about p^2 N^2 against the unbiased estimator.  Of the
    shipped configs only args_dptest sets loss_weight ("prop-t"), so its
    loss is the one that differs from the reference's."""
    view = streams.of(generator)
    p = weight_table / weight_table.sum()
    t = view.choice(p, batch)
    weights = streams.host_to(1.0 / (weight_table.shape[0] * p), view.device)
    return t, weights[t]


def calc_total_vlb(model_fn: ModelFn, sched: Schedule, x_0: torch.Tensor,
                   generator: Stream,
                   noise_sampler: NoiseSampler = gaussian_noise
                   ) -> Dict[str, torch.Tensor]:
    """The full T-step VLB sweep, a Python loop over t = T-1 .. 0 with no
    host syncs; the noise of each step is Gaussian (`noise_sampler` is for
    tests that inject it).

    Returns total_vlb and prior_vlb, (B,), and vb, x_0_mse and mse, (B, T),
    ordered by descending t (column i is t = T-1-i)."""
    vb, x0_mse, mse = [], [], []
    k = generator
    for t in range(sched.num_timesteps - 1, -1, -1):
        k, sub = streams.of(k).split()
        t_batch = torch.full((x_0.shape[0],), t, dtype=torch.int64,
                             device=x_0.device)
        noise = noise_sampler(x_0.shape, t_batch, sub).to(x_0.dtype)
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
