"""The schedule, the forward jump and the DDPM and DDIM reverse updates.

A frozen copy of `anoddpm_torch/schedule.py` (`get_beta_schedule`,
`make_schedule`: float64 numpy, stored as fp32) and of the update
equations of `anoddpm_torch/diffusion.py` (`sample_q`, `p_mean_variance`,
`sample_p`, `ddim_timesteps`, `ddim_step`) as the benchmark was defined.
Tensors are NCHW fp32 and timesteps (B,) int64.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch


def beta_schedule(steps: int, name: str) -> np.ndarray:
    if name == "linear":
        scale = 1000 / steps
        return np.linspace(scale * 0.0001, scale * 0.02, steps, dtype=np.float64)
    if name == "cosine":
        f = lambda t: np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        s = np.arange(steps, dtype=np.float64)
        return np.minimum(1.0 - f((s + 1) / steps) / f(s / steps), 0.999)
    raise ValueError(f"unknown beta schedule {name!r}")


def schedule(cfg: dict, device) -> SimpleNamespace:
    """The (T,) fp32 tables the updates read, on `device`."""
    betas = beta_schedule(int(cfg["T"]), str(cfg["beta_schedule"]))
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    model_var = np.append(post_var[1], betas[1:])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return SimpleNamespace(
        T=len(betas), alphas_cumprod=f32(acp),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
        coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        model_log_variance=f32(np.log(model_var)))


def at(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return table[t].view(-1, 1, 1, 1)


def sample_q(s, x0, t, noise):
    return at(s.sqrt_alphas_cumprod, t) * x0 + at(s.sqrt_one_minus_alphas_cumprod, t) * noise


def ddpm_step(s, x, t, eps, noise):
    """x_t -> x_{t-1}: the posterior mean at the clamped x0 estimate, plus
    the fixed model deviation times the noise where t > 0."""
    x0 = torch.clamp(at(s.sqrt_recip_alphas_cumprod, t) * x
                     - at(s.sqrt_recipm1_alphas_cumprod, t) * eps, -1.0, 1.0)
    mean = at(s.coef1, t) * x0 + at(s.coef2, t) * x
    nonzero = (t != 0).to(x.dtype).view(-1, 1, 1, 1)
    return mean + nonzero * torch.exp(0.5 * at(s.model_log_variance, t)) * noise


def ddim_timesteps(t_distance: int, num_steps: int) -> list:
    """S descending timesteps ending at 0: the fp32 linspace grid of the
    JAX package as XLA evaluates it, rounded half to even."""
    num_steps = min(num_steps, t_distance)
    div = num_steps - 1
    if div < 1:
        return [0] * max(num_steps, 0)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    stop = f32(float(t_distance - 1))
    step = stop * (f32(1.0) / f32(float(div)))
    grid = torch.cat([step * torch.arange(div, dtype=torch.float32), stop.view(1)])
    return torch.round(grid).to(torch.int64).flip(0).tolist()


def ddim_step(s, x, t, t_prev: int, eps, eta: float, noise):
    """x_t -> x_{t_prev} (t_prev = -1: to x0), eps re-derived from the
    clamped x0."""
    acp_t = at(s.alphas_cumprod, t)
    acp_prev = (torch.ones_like(acp_t) if t_prev < 0
                else at(s.alphas_cumprod, torch.full_like(t, t_prev)))
    x0 = torch.clamp((x - torch.sqrt(1.0 - acp_t) * eps) / torch.sqrt(acp_t),
                     -1.0, 1.0)
    eps_hat = (x - torch.sqrt(acp_t) * x0) / torch.sqrt(1.0 - acp_t)
    sigma = (eta * torch.sqrt((1.0 - acp_prev) / (1.0 - acp_t))
             * torch.sqrt(1.0 - acp_t / acp_prev))
    x_prev = (torch.sqrt(acp_prev) * x0
              + torch.sqrt(torch.clamp(1.0 - acp_prev - sigma ** 2, min=0.0)) * eps_hat)
    if noise is not None:
        x_prev = x_prev + sigma * noise
    return x_prev


class Draws:
    """The random draws of a run, replayed in the order the port's
    samplers make them from a torch.Generator (`streams._TorchView`):
    t ~ U[0, high) and uint32 lattice seeds, both int64 on the generator's
    device."""

    def __init__(self, generator: torch.Generator):
        self.g = generator
        self.device = generator.device

    def randint(self, n: int, high: int) -> torch.Tensor:
        return torch.randint(0, high, (n,), generator=self.g, device=self.device)

    def seeds(self, n: int) -> torch.Tensor:
        return torch.randint(0, 1 << 32, (n,), generator=self.g,
                             device=self.device, dtype=torch.int64)


def _octaves(cfg: dict):
    if str(cfg.get("noise_fn")) != "simplex" or cfg.get("simplex_table"):
        raise ValueError("the reference draws the hash-path simplex noise only")
    return (int(cfg.get("simplex_octaves", 6) or 6),
            float(cfg.get("simplex_persistence", 0.8) or 0.8),
            float(cfg.get("simplex_frequency", 64) or 64))


def simplex(cfg: dict, shape, t: torch.Tensor, draws: Draws) -> torch.Tensor:
    """The simplex noise of one call: one octave field per (sample,
    channel), on the plane z = t[sample], from B*C fresh seeds."""
    from .simplex import octave_field
    b, c, h, w = shape
    tt = t.to(torch.float32)[:, None].expand(b, c).reshape(b * c)
    return octave_field(draws.seeds(b * c), tt, (h, w),
                        *_octaves(cfg)).view(b, c, h, w)


def chain_noise(cfg: dict, shape, planes, draws: Draws, rows=None,
                chunk: int = 16) -> torch.Tensor:
    """The fields of a whole chain, (len(planes), R, C, H, W): the seeds of
    every call drawn first, in the port's order (B*C a call), since no
    draw depends on a value, then the fields of `rows` (all when None) on
    the planes z = planes[i], `chunk` calls at a time."""
    from .simplex import octave_field
    b, c, h, w = shape
    rows = list(range(b)) if rows is None else list(rows)
    seeds = torch.stack([draws.seeds(b * c).view(b, c)[rows] for _ in planes])
    tt = torch.tensor([float(p) for p in planes], device=seeds.device)
    tt = tt[:, None, None].expand(seeds.shape).reshape(-1)
    seeds = seeds.reshape(-1)
    per = len(rows) * c * chunk
    fields = [octave_field(seeds[i:i + per], tt[i:i + per], (h, w),
                           *_octaves(cfg))
              for i in range(0, seeds.numel(), per)]
    return torch.cat(fields).view(len(planes), len(rows), c, h, w)


def reconstruct(model, s, cfg: dict, x0: torch.Tensor, lam: int,
                draws: Draws, sampler: str = "ddpm", steps: int = 0,
                eta: float = 0.0, batch: int = 0, rows=None) -> torch.Tensor:
    """Partial diffusion of x0 (B, C, H, W): one q-jump to t = lam - 1, then
    lam DDPM steps or `steps` DDIM steps at `eta`, with the noise drawn as
    the port draws it (the jump's field first, then one per step; DDIM
    only at eta > 0).  With `rows`, x0 holds those rows of a batch of
    `batch`, whose draws are made and the others' discarded: the rows of a
    batch are independent."""
    full = lambda v: torch.full((x0.shape[0],), v, dtype=torch.int64,
                                device=x0.device)
    shape = ((batch,) + tuple(x0.shape[1:])) if rows is not None else x0.shape
    ts = (ddim_timesteps(lam, steps) if sampler == "ddim"
          else list(range(lam - 1, -1, -1)))
    noisy = sampler != "ddim" or eta > 0
    noise = chain_noise(cfg, shape, [lam - 1] + (ts if noisy else []), draws,
                        rows)
    x = sample_q(s, x0, full(lam - 1), noise[0])
    if sampler == "ddim":
        for i, (ti, tp) in enumerate(zip(ts, ts[1:] + [-1])):
            t = full(ti)
            x = ddim_step(s, x, t, tp, model(x, t), eta,
                          noise[i + 1] if noisy else None)
        return x
    for i, ti in enumerate(ts):
        t = full(ti)
        x = ddpm_step(s, x, t, model(x, t), noise[i + 1])
    return x
