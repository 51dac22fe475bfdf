"""The frozen plain reference against the port's plain paths on the CPU,
at 32x32, fp32, on seeded non-zero weights: the UNet forward, one DDPM
step, one DDIM step, a whole chain with its draws, and one train step.
(The tests import the port; the reference does not.)"""

import copy

import numpy as np
import pytest
import torch

from anoddpm_torch import diffusion as dm
from anoddpm_torch.models.unet import unet_from_args
from anoddpm_torch.ops.noise import sampler_from_args
from anoddpm_torch.schedule import schedule_from_args
from anoddpm_torch.train import dispatch_of
from anoddpm_torch.training import init_train_state, make_optimizer
from benchmark.core import entry_train, weights
from benchmark.reference import diffusion as rd
from benchmark.reference import train as rt
from benchmark.reference import unet as ru
from benchmark.tests.tiny import SEED, cell


def fp32_cfg(name="paper128.detect.ddpm200.b8", s2d=1):
    cfg = copy.deepcopy(cell(name).cfg)
    cfg["compute_dtype"] = "float32"
    cfg["space_to_depth"] = s2d
    if s2d > 1:
        cfg["img_size"] = [64, 64]
    return cfg


def pair(cfg):
    sd = weights.make(cfg, SEED, "cpu")
    assert all(float(v.abs().max()) > 0 for v in sd.values())
    port = unet_from_args(cfg, 1)
    port.load_state_dict(sd)
    ref = ru.unet_of(cfg)
    ref.load_state_dict(sd)
    return port.eval(), ref.eval()


@pytest.mark.parametrize("s2d", [1, 2])
def test_unet_forward(s2d):
    cfg = fp32_cfg(s2d=s2d)
    port, ref = pair(cfg)
    hw = cfg["img_size"][0]
    x = torch.randn((2, 1, hw, hw), generator=torch.Generator().manual_seed(1))
    t = torch.tensor([3, 150])
    with torch.no_grad():
        a, b = port(x, t), ref(x, t)
    assert float(b.abs().max()) > 0.1
    assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_reverse_updates():
    cfg = fp32_cfg()
    sched, s = schedule_from_args(cfg), rd.schedule(cfg, "cpu")
    g = torch.Generator().manual_seed(2)
    x, eps, noise = (torch.randn((2, 1, 32, 32), generator=g) for _ in range(3))
    t = torch.tensor([0, 199])
    got, _ = dm.sample_p(lambda *_: eps, sched, x, t, None,
                         lambda shape, tt, gen: noise)
    assert torch.allclose(got, rd.ddpm_step(s, x, t, eps, noise), atol=1e-6)
    assert rd.ddim_timesteps(200, 15) == dm.ddim_timesteps(200, 15).tolist()
    for t_prev in (120, -1):
        tt = torch.tensor([199, 199])
        got, _ = dm.ddim_step(sched, x, tt, torch.full_like(tt, t_prev), eps,
                              1.0, noise)
        want = rd.ddim_step(s, x, tt, t_prev, eps, 1.0, noise)
        assert torch.allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_chain_with_its_draws(sampler):
    cfg = fp32_cfg()
    port, ref = pair(cfg)
    sched, s = schedule_from_args(cfg), rd.schedule(cfg, "cpu")
    x0 = torch.rand((2, 1, 32, 32), generator=torch.Generator().manual_seed(3)) * 2 - 1
    noise = sampler_from_args(cfg)
    with torch.no_grad():
        if sampler == "ddim":
            a = dm.forward_backward_ddim(port, sched, x0, 6, 3,
                                         torch.Generator().manual_seed(4),
                                         noise_sampler=noise, eta=1.0)
        else:
            a = dm.forward_backward(port, sched, x0, 6,
                                    torch.Generator().manual_seed(4),
                                    noise_sampler=noise)
        b = rd.reconstruct(ref, s, cfg, x0, 6,
                           rd.Draws(torch.Generator().manual_seed(4)),
                           sampler, 3, 1.0)
    assert float((a - b).abs().max()) <= 1e-4


def test_train_step():
    cfg = fp32_cfg("paper128.train.b8")
    port, ref = pair(cfg)
    port.train()
    opt = make_optimizer(port.parameters(), float(cfg["lr"]))
    state = init_train_state(port, opt)
    step, _ = dispatch_of(cfg, schedule_from_args(cfg), sampler_from_args(cfg))
    x0 = torch.rand((2, 1, 32, 32), generator=torch.Generator().manual_seed(5)) * 2 - 1
    loss = step(state, x0, torch.Generator().manual_seed(6))["loss"]
    params = [p for _, p in port.named_parameters()]
    g_port = entry_train.leaf_norms(
        [opt.adamw.state[p]["exp_avg"] for p in params]) / 0.1
    rstate = rt.State(ref)
    out = rt.train_step(rstate, rd.schedule(cfg, "cpu"), cfg, x0,
                        rd.Draws(torch.Generator().manual_seed(6)))
    g_ref = entry_train.leaf_norms(out["grads"])
    assert abs(float(loss) - float(out["loss"])) <= 1e-5 * float(out["loss"])
    floor = np.maximum(g_ref, np.median(g_ref))
    assert np.max(np.abs(g_port - g_ref) / floor) <= 1e-4
    ema = dict(state.ema.named_parameters())
    for n, e, p in zip(rstate.names, rstate.ema, rstate.params):
        assert torch.allclose(ema[n], e, atol=1e-6)
        q = dict(port.named_parameters())[n]
        # AdamW's first step is lr * sign(g) but where |g| nears eps
        assert float((q - p).detach().abs().max()) <= 2 * float(cfg["lr"]) + 1e-6
