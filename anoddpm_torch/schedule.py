"""Diffusion noise schedules as a dataclass of fp32 tensors.

The same float64 numpy math as `anoddpm_tpu/schedule.py`, stored as float32
tensors; `Schedule.to(device)` moves every buffer at once.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch


def get_beta_schedule(num_diffusion_steps: int, name: str = "cosine") -> np.ndarray:
    """Beta schedule (reference GaussianDiffusion.py:12-29): improved-DDPM
    cosine capped at 0.999, or linear 1e-4 -> 0.02 scaled by 1000/T."""
    if name == "cosine":
        max_beta = 0.999
        f = lambda t: np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        steps = np.arange(num_diffusion_steps, dtype=np.float64)
        t1 = steps / num_diffusion_steps
        t2 = (steps + 1) / num_diffusion_steps
        return np.minimum(1.0 - f(t2) / f(t1), max_beta)
    if name == "linear":
        scale = 1000 / num_diffusion_steps
        return np.linspace(scale * 0.0001, scale * 0.02, num_diffusion_steps,
                           dtype=np.float64)
    raise NotImplementedError(f"unknown beta schedule: {name}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Precomputed diffusion quantities, each a (T,) float32 tensor, plus
    the fixed reverse-process variance append(posterior_var[1], betas[1:])."""

    betas: torch.Tensor
    sqrt_alphas: torch.Tensor
    sqrt_betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    model_variance: torch.Tensor
    model_log_variance: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "Schedule":
        return Schedule(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})


def make_schedule(betas: np.ndarray) -> Schedule:
    betas = np.asarray(betas, dtype=np.float64)
    if (betas >= 1.0).any():
        warnings.warn(
            "beta schedule contains values >= 1 (linear schedule at small T "
            "scales by 1000/T — reference formula); downstream sqrt terms "
            "will be NaN. Use the cosine schedule for T < 50.",
            RuntimeWarning)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

    # Clipped intermediates keep degenerate schedules (betas >= 1, or T=1
    # where the posterior variance is identically 0) finite; for
    # well-formed schedules the clips are no-ops.
    tiny = np.finfo(np.float64).tiny
    alphas_pos = np.clip(alphas, 0.0, None)
    acp_pos = np.clip(alphas_cumprod, 1e-20, None)
    one_minus_acp = np.clip(1.0 - alphas_cumprod, tiny, None)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / one_minus_acp
    pv1 = posterior_variance[min(1, len(betas) - 1)]
    posterior_log_variance_clipped = np.log(
        np.clip(np.append(pv1, posterior_variance[1:]), tiny, None))
    model_variance = np.append(pv1, betas[1:])

    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    return Schedule(
        betas=f32(betas),
        sqrt_alphas=f32(np.sqrt(alphas_pos)),
        sqrt_betas=f32(np.sqrt(np.clip(betas, 0.0, None))),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(acp_pos)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(one_minus_acp)),
        log_one_minus_alphas_cumprod=f32(np.log(one_minus_acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp_pos)),
        sqrt_recipm1_alphas_cumprod=f32(
            np.sqrt(np.clip(1.0 / acp_pos - 1.0, 0.0, None))),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(
            betas * np.sqrt(np.clip(alphas_cumprod_prev, 0.0, None))
            / one_minus_acp),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas_pos) / one_minus_acp),
        model_variance=f32(model_variance),
        model_log_variance=f32(np.log(np.clip(model_variance, tiny, None))),
    )


def schedule_from_args(args) -> Schedule:
    return make_schedule(get_beta_schedule(int(args["T"]), args["beta_schedule"]))
