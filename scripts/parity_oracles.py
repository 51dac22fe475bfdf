"""How far the JAX package (eager and jit) and the port each lie from a
float64 evaluation of the same function from the same inputs, at the
port's CPU parity checks whose rules are stated from that conditioning
(`tests/test_torch_*.py`, docstrings there).

    JAX_PLATFORMS=cpu python scripts/parity_oracles.py [check ...]

Checks (all by default): `ddim` (one DDIM step at eta 1, T 20 cosine, per
sample), `detect` (the JAX-stream DDIM eta 1 detection groups with
Gaussian noise; the oracle runs the port's model in float64 on normals
computed in float64 from the same fp32 uniforms), `ce` (the context
encoder's sliding-window error map and inpainting), `graph` (graph_data
on the JAX keys: one process, 2 gloo ranks, and each rank's rows computed
in one process at its batch shape), `site` (the fp32 flax norm+SiLU site
at the site shapes of tests/test_torch_norm_paths.py and
tests/test_torch_flax_order.py, in ulps of its largest magnitude),
`rsqrt`, `sigmoid` (fp32 XLA vs torch vs correctly rounded, in ulps),
`simplex` (opensimplex3 against the float64 golden), `ema` (one EMA
update).  Runs the JAX package on the CPU beside the port, as the tests
do; it is not part of the port."""

import os
import sys
import tempfile
import warnings
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_parity import CONFIGS, flax_and_port, nchw, nhwc  # noqa: E402


def float64_model(port):
    """The port's UNet or CE with float64 weights and compute dtype."""
    port = port.double()
    for m in port.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return port


def float64_norms():
    """`.float()` leaves float64 alone (the norms cast to fp32)."""
    real = torch.Tensor.float
    return mock.patch.object(torch.Tensor, "float", lambda self, *a, **k:
                             self if self.dtype == torch.float64
                             else real(self, *a, **k))


def check_ddim():
    from anoddpm_tpu import diffusion as jd
    from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
    from anoddpm_torch import diffusion as td
    from anoddpm_torch import schedule as ts
    js = make_schedule(get_beta_schedule(20, "cosine"))
    tsch = ts.make_schedule(ts.get_beta_schedule(20, "cosine"))
    rng = np.random.default_rng(1)                 # test_ddim_step_matches_jax
    x = rng.normal(size=(3, 8, 8, 1)).astype(np.float32)
    eps = rng.normal(size=x.shape).astype(np.float32)
    noise = rng.normal(size=x.shape).astype(np.float32)
    t, tp = np.array([19, 9, 4]), np.array([12, 3, -1])
    acp = tsch.alphas_cumprod.double().numpy()
    a_t = acp[t][:, None, None, None]
    a_p = np.where(tp < 0, 1.0, acp[np.maximum(tp, 0)])[:, None, None, None]
    X, E, N = (v.astype(np.float64) for v in (x, eps, noise))
    x0 = np.clip((X - np.sqrt(1 - a_t) * E) / np.sqrt(a_t), -1, 1)
    eh = (X - np.sqrt(a_t) * x0) / np.sqrt(1 - a_t)
    sig = np.sqrt((1 - a_p) / (1 - a_t)) * np.sqrt(1 - a_t / a_p)
    want = np.sqrt(a_p) * x0 + np.sqrt(np.maximum(1 - a_p - sig ** 2, 0)) * eh + sig * N
    args = (jnp.asarray(x), jnp.asarray(t, jnp.int32), jnp.asarray(tp, jnp.int32),
            jnp.asarray(eps))
    eager = jd.ddim_step(js, *args, 1.0, jnp.asarray(noise))[0]
    jit = jax.jit(lambda *a: jd.ddim_step(js, *a, 1.0, jnp.asarray(noise)))(*args)[0]
    port = nhwc(td.ddim_step(tsch, nchw(x), torch.from_numpy(t), torch.from_numpy(tp),
                             nchw(eps), 1.0, nchw(noise))[0])
    for name, v in (("jax eager", eager), ("jax jit", jit), ("port", port)):
        d = np.abs(np.asarray(v, np.float64) - want)
        print(f"ddim eta 1 x_prev, {name}: per sample "
              + ", ".join(f"{d[i].max():.3g}" for i in range(3)))
    print(f"ddim: jax eager - jit {np.abs(np.asarray(eager) - np.asarray(jit)).max():.3g}")


def check_detect():
    from anoddpm_tpu import detect as jdetect
    from anoddpm_tpu.config import defaultdict_from_json
    from anoddpm_tpu.schedule import get_beta_schedule, make_schedule
    from anoddpm_tpu.training import EvalModel
    from anoddpm_torch import detect as tdetect
    from anoddpm_torch import schedule as ts
    from anoddpm_torch.compat import jax_random as jr
    from anoddpm_torch.data import pipeline
    from test_torch_jax_streams import DETECT
    fmodel, params, port = flax_and_port(CONFIGS["s2d1"])
    oracle_model = float64_model(flax_and_port(CONFIGS["s2d1"])[2])
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

    def normal64(k, shape=()):
        return torch.special.erfinv(jr.uniform(k, shape, lo, 1.0).double()) * np.sqrt(2.0)

    def recons(module, em, sched, over, patches=(), **kw):
        out = []
        real = module.M.batched_anomaly_metrics

        def record(images, recon, masks):
            out.append(np.asarray(recon, np.float64))
            return real(images, np.asarray(recon, np.float32), masks)
        with mock.patch.object(module.M, "batched_anomaly_metrics", record), \
                tempfile.TemporaryDirectory() as root:
            for p in patches:
                p.start()
            try:
                module.anomalous_metric_calculation(
                    args=defaultdict_from_json({**DETECT, **protocol, **over}),
                    root_dir=root, em=em, sched=sched, **kw)
            finally:
                for p in patches:
                    p.stop()
        return out
    for name, protocol in (
            ("ddim_eta1", {"sampler": "ddim", "ddim_steps": 5, "ddim_eta": 1.0}),
            ("ddim_x2", {"sampler": "ddim", "ddim_steps": 4, "ddim_eta": 1.0,
                         "recon_repeats": 2})):
        gauss = {"noise_fn": "gauss"}
        jsched = make_schedule(get_beta_schedule(20, "cosine"))
        tsched = ts.make_schedule(ts.get_beta_schedule(20, "cosine"))
        jit = recons(jdetect, EvalModel(fmodel, params), jsched, gauss)
        with jax.disable_jit():
            eager = recons(jdetect, EvalModel(fmodel, params), jsched, gauss)
        port_r = recons(tdetect, port, tsched, {**gauss, "rng": "jax"}, device="cpu")
        to_nchw = pipeline.to_nchw
        oracle = recons(tdetect, oracle_model, tsched, {**gauss, "rng": "jax"},
                        (mock.patch.object(jr, "normal", normal64),
                         mock.patch.object(tdetect, "to_nchw",
                                           lambda a: to_nchw(a).double()),
                         float64_norms()), device="cpu")
        for label, got in (("jax eager", eager), ("jax jit", jit), ("port", port_r)):
            d = [np.abs(g - o) for g, o in zip(got, oracle)]
            print(f"detect {name} gauss, {label}: max "
                  + ", ".join(f"{x.max():.3g}" for x in d) + "; within 1e-4 "
                  + ", ".join(f"{(x <= 1e-4).mean():.4f}" for x in d))


def check_ce():
    import torch.nn.functional as F
    from anoddpm_tpu.models import context_encoder as jce
    from anoddpm_torch.compat.flax_params import context_encoder_state_dict_from_flax
    from anoddpm_torch.models import context_encoder as tce
    fmodel = jce.ContextEncoder(base_channels=16)     # test_torch_context_encoder
    params = fmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 1)),
                         jnp.zeros((1, 32, 32, 1)))
    state = context_encoder_state_dict_from_flax(params)
    port = tce.ContextEncoder(in_channels=1, base_channels=16)
    port.load_state_dict(state, strict=True)
    oracle_model = tce.ContextEncoder(in_channels=1, base_channels=16).double()
    oracle_model.load_state_dict({k: v.double() for k, v in state.items()})
    x = np.random.default_rng(2).uniform(-1, 1, size=(2, 32, 32, 1)).astype(np.float32)
    for fn in ("sliding_window_error", "sliding_window_inpaint"):
        jit = getattr(jce, fn)(fmodel, params, jnp.asarray(x), 4)
        with jax.disable_jit():
            eager = getattr(jce, fn)(fmodel, params, jnp.asarray(x), 4)
        got = nhwc(getattr(tce, fn)(port.eval(), nchw(x), 4))
        with mock.patch.object(tce.GroupNorm8, "forward", lambda self, h: F.group_norm(
                h, 8, self.weight, self.bias, eps=1e-6)), torch.no_grad():
            oracle = nhwc(getattr(tce, fn)(oracle_model.eval(), nchw(x).double(), 4))
        print(f"ce {fn} (largest |value| {np.abs(oracle).max():.3g}): "
              + "; ".join(f"{n} {np.abs(np.asarray(v, np.float64) - oracle).max():.3g}"
                          for n, v in (("jax eager", eager), ("jax jit", jit),
                                       ("port", got))))


def check_graph():
    import test_torch_parallel as tp
    with tempfile.TemporaryDirectory() as root:
        roots = {k: os.path.join(root, f"w{k}") for k in (1, 2, 3)}
        for r in roots.values():
            os.makedirs(r)
            tp.write_checkpoint(r)
        control = tp.staged_ranks(roots[3])["recons"]
        one = tp.jax_graph(None, roots[1])
        two = tp.run_ranks(tp._jax_graph_worker, roots[2])
    for i, (a, b, c) in enumerate(zip(two["recons"], one["recons"], control)):
        print(f"graph chunk {i}: 2 ranks - control {np.abs(a - c).max():.3g}; "
              f"2 ranks - one process {np.abs(a - b).max():.3g}; control - one "
              f"process {np.abs(c - b).max():.3g}")


def check_site():
    from test_torch_flax_order import SITES
    from test_torch_norm_paths import SITE_SHAPES, jax_site, port_site, site_inputs
    from anoddpm_torch.ops import group_norm_silu as gn
    cases = ([("norm_paths", s, 0) for s in SITE_SHAPES]
             + [("flax_order", (2, h, w, c), c + h) for c, h, w in SITES])
    for label, shape, seed in cases:
        x, g, gamma, beta = site_inputs(shape, seed)
        X = x.astype(np.float64)
        n, h, w, c = X.shape
        xg = X.reshape(n, h * w, 32, c // 32)
        mu = xg.mean(axis=(1, 3), keepdims=True)
        var = ((xg - mu) ** 2).mean(axis=(1, 3), keepdims=True)
        hh = ((xg - mu) / np.sqrt(var + 1e-5)).reshape(X.shape) * gamma + beta
        oracle = hh / (1 + np.exp(-hh))
        ulp = np.spacing(np.float32(np.abs(oracle).max()))
        p = {"params": {"GroupNorm32_0": {"GroupNorm_0": {
            "scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}}}
        from test_torch_norm_paths import FlaxSite
        jit = jax.jit(lambda q, xx: FlaxSite(False).apply(q, xx))(p, jnp.asarray(x))
        eager = jax_site(x, g, gamma, beta, False, jnp.float32)[0]
        port = (port_site(x, g, gamma, beta, False, torch.float32)[0]
                if label == "norm_paths" else nhwc(gn.group_norm_silu(
                    nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                    order="flax", bf16_path=False)))
        print(f"site {label} {shape}, ulps of the largest from float64: "
              + "; ".join(f"{n} {np.abs(np.asarray(v, np.float64) - oracle).max() / ulp:.2f}"
                          for n, v in (("jax eager", eager), ("jax jit", jit),
                                       ("port", port))))


def _ulps(name, fn64, jax_fn, torch_fn, values):
    exact = fn64(values.astype(np.float64))
    rounded = exact.astype(np.float32)
    jit = np.asarray(jax.jit(jax_fn)(jnp.asarray(values)))
    for label, v in (("jax", jit), ("torch", torch_fn(torch.from_numpy(values)).numpy()),
                     ("correctly rounded", rounded)):
        e = np.abs(v.astype(np.float64) - exact) / np.spacing(v).astype(np.float64)
        print(f"{name} {label}: max {e.max():.3f} ulps, mean {e.mean():.3f}, "
              f"equal to jax's {np.mean(v == jit):.4f}")


def check_rsqrt():
    _ulps("rsqrt", lambda v: 1 / np.sqrt(v), jax.lax.rsqrt, torch.rsqrt,
          np.random.default_rng(0).uniform(0.01, 10, 200000).astype(np.float32))


def check_sigmoid():
    _ulps("sigmoid", lambda v: 1 / (1 + np.exp(-v)), jax.nn.sigmoid, torch.sigmoid,
          np.random.default_rng(0).uniform(-8, 8, 400000).astype(np.float32))


def check_simplex():
    from anoddpm_tpu.ops import simplex as jsx
    from anoddpm_torch.ops import simplex as tsx
    g = dict(np.load(os.path.join(ROOT, "tests", "golden", "golden_noise3.npz")))
    pts = g["pts"].astype(np.float32)
    perm, gid = g["perm"], g["pgi"] // 3
    args = (jnp.asarray(perm, jnp.int32), jnp.asarray(gid, jnp.int32),
            *(jnp.asarray(pts[:, i]) for i in range(3)))
    jit = jax.jit(jsx.opensimplex3)(*args)
    with jax.disable_jit():
        eager = jsx.opensimplex3(*args)
    t64 = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    port = tsx.opensimplex3(t64(perm), t64(gid),
                            *(torch.from_numpy(pts[:, i].copy()) for i in range(3)))
    for name, v in (("jax eager", eager), ("jax jit", jit), ("port", port)):
        e = np.abs(np.asarray(v, np.float64) - g["vals"])
        print(f"simplex opensimplex3 vs golden, {name}: median {np.median(e):.3g}, "
              f"max {e.max():.3g}")


def check_ema():
    from anoddpm_tpu.models.ema import ema_update as jema
    from anoddpm_torch.models.ema import ema_update as tema
    rng = np.random.default_rng(0)
    e = rng.normal(0, 0.3, 200000).astype(np.float32)
    e[:1000] = 1 + rng.normal(0, 1e-3, 1000)
    p = (e + rng.normal(0, 1e-3, e.shape)).astype(np.float32)
    decay = 0.9999
    exact = e.astype(np.float64) * decay + p.astype(np.float64) * (1 - decay)
    jit = jax.jit(lambda a, b: jema({"w": a}, {"w": b}, decay))(
        jnp.asarray(e), jnp.asarray(p))["w"]
    eager = jema({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, decay)["w"]
    port = torch.from_numpy(e.copy())
    tema([port], [torch.from_numpy(p)], decay)
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    for name, v in (("jax eager", eager), ("jax jit", jit), ("port", port.numpy())):
        r = np.abs(np.asarray(v, np.float64) - exact) / ulp
        print(f"ema, {name}: max {r.max():.3f} ulps, mean {r.mean():.3f}")


CHECKS = {"ddim": check_ddim, "detect": check_detect, "ce": check_ce,
          "graph": check_graph, "site": check_site, "rsqrt": check_rsqrt,
          "sigmoid": check_sigmoid, "simplex": check_simplex, "ema": check_ema}


if __name__ == "__main__":
    warnings.simplefilter("ignore")
    for name in sys.argv[1:] or list(CHECKS):
        CHECKS[name]()
