"""The training entry: the config's train step (`train.dispatch_of`: t and
the simplex noise, the l2 loss through the UNet, the backward with K2b,
the global-norm clip, AdamW, the EMA), one step per dispatch, on healthy
slices copied to the card from pinned memory without blocking, as
`train.train` copies them.

Set-up builds the train state once (`training.make_optimizer`,
`init_train_state` on the UNet of `unet_from_args` with the seeded
weights), drives it through its first three steps on 24 distinct slices
through the same feed and dispatch as the window, reads what the check
compares (the losses; the gradient AdamW took at step 1, from its first
moment, (exp_avg - beta1 exp_avg before) / (1 - beta1); the change of the
parameters and of the EMA after step 3, before step 4 moves them), and
hands that same state to the window.  The window dispatches steps until
`--seconds` have passed, then synchronises.  Once the peak is read, the
state the window reached is copied (parameters, AdamW's moments and step,
the EMA, the generator) and driven three steps more through the same feed
and dispatch, and the same numbers are read again: the "late" stage,
which the reference follows from that copy.

Traffic keys: pool_slices (distinct healthy slices from the seed, a
multiple of the batch, taken in turn), trace_steps (steps profiled under
`--trace 1`).
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import diffusion as rd
from ..reference import train as rt
from ..reference import unet as ru
from . import synthetic, trace, weights
from .entry_detect import sync_of
from .seeds import sub_seed

CHECKED_STEPS = 3


@torch.no_grad()
def leaf_norms(tensors: List[torch.Tensor]) -> np.ndarray:
    """The L2 norm of each tensor, float64 on the host."""
    return torch.stack(torch._foreach_norm(
        [t.detach().float() for t in tensors])).double().cpu().numpy()


class Entry:
    def __init__(self, cell, run, seed: int, device):
        self.cell, self.run, self.seed, self.device = cell, run, seed, device
        self.cfg, self.tr = cell.cfg, cell.traffic
        self.sync = sync_of(device)
        self.readings: Dict[str, object] = {}
        self.refs: Dict[tuple, Dict[str, object]] = {}
        self.i = 0

    def setup(self) -> None:
        from anoddpm_torch.models.unet import unet_from_args
        from anoddpm_torch.ops.noise import sampler_from_args
        from anoddpm_torch.schedule import schedule_from_args
        from anoddpm_torch.train import dispatch_of
        from anoddpm_torch.training import init_train_state, make_optimizer

        cfg = self.cfg
        self.b = int(cfg["Batch_Size"])
        img = cfg["img_size"]
        hw = int(img[0] if isinstance(img, (list, tuple)) else img)
        n = int(self.tr["pool_slices"])
        if n % self.b or n < CHECKED_STEPS * self.b:
            raise ValueError("pool_slices must be a multiple of the batch "
                             "and hold the checked steps' rows")
        pool = np.stack([synthetic.healthy(self.seed, i, hw, hw)
                         for i in range(n)])[:, None]
        self.pool = torch.from_numpy(pool)
        if self.device.type == "cuda":
            self.pool = self.pool.pin_memory()
        with torch.device(self.device):
            model = unet_from_args(cfg, 1)
        p0 = weights.make(cfg, self.seed, self.device)
        model.load_state_dict(p0)
        optimizer = make_optimizer(model.parameters(), float(cfg["lr"]),
                                   float(cfg.get("weight_decay", 0) or 0),
                                   float(cfg.get("grad_clip_norm", 1.0) or 1.0))
        self.state = init_train_state(model, optimizer)
        sched = schedule_from_args(cfg).to(self.device)
        self.step_fn, _ = dispatch_of(cfg, sched, sampler_from_args(cfg))
        self.gen = torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, "train"))
        names = [name for name, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        ema = dict(self.state.ema.named_parameters())
        self.ema = [ema[n] for n in names]
        p0 = [p0[n] for n in names]
        self.readings = {"names": names, "start": self.steps(p0, p0, None)}
        del p0, ema
        self.sync()

    def moments(self, key: str) -> List[torch.Tensor]:
        """AdamW's `key` ("exp_avg", "exp_avg_sq") of each leaf; zeros
        before its first step."""
        adam = self.state.optimizer.adamw.state
        return [adam[p][key] if key in adam.get(p, {})
                else torch.zeros_like(p) for p in self.params]

    def steps(self, p_before, e_before, m_before) -> Dict[str, object]:
        """CHECKED_STEPS dispatches from the present state, and what the
        check compares: each step's loss, the first step's gradient as
        AdamW took it (from its first moment and `m_before`, the moment
        before; None: zero), the change of the parameters and of the EMA
        from `p_before` and `e_before`, and the rows' places in the pool."""
        beta1 = rt.BETAS[0]
        losses, rows = [], []
        for k in range(CHECKED_STEPS):
            rows.append(self.at())
            losses.append(self.dispatch()["loss"])
            if k == 0:
                m = self.moments("exp_avg")
                if m_before is not None:
                    m = [a - beta1 * b for a, b in zip(m, m_before)]
                grad = leaf_norms(m) / (1.0 - beta1)
        return {"loss": [float(x) for x in losses], "grad": grad, "rows": rows,
                "update": leaf_norms([p - b for p, b in
                                      zip(self.params, p_before)]),
                "ema": leaf_norms([e - b for e, b in zip(self.ema, e_before)])}

    def at(self) -> int:
        return (self.i * self.b) % self.pool.shape[0]

    def rows(self) -> torch.Tensor:
        at = self.at()
        return self.pool[at:at + self.b]

    def dispatch(self):
        x = self.rows().to(self.device, non_blocking=True)
        self.i += 1
        return self.step_fn(self.state, x, self.gen)

    def traced(self) -> None:
        window = trace.Window(self.sync)
        steps = int(self.tr["trace_steps"])
        window.start()
        for _ in range(steps):
            with trace.span("dispatch"):
                self.dispatch()
        window.stop({"steps": steps, "batch": self.b})
        self.run.trace = window.summary

    def measure(self, seconds: float) -> None:
        run = self.run
        run.window_start = start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            self.dispatch()
            run.add("dispatch", time.perf_counter() - t0)
            run.attempted += 1
            if time.perf_counter() - start >= seconds:
                break
        self.sync()
        run.window_s = time.perf_counter() - start
        run.units = run.attempted * self.b

    def release(self) -> None:
        """The late stage: a copy of the state the window reached, for the
        reference to follow, and three steps more from it through the same
        feed and dispatch; then the program's state is freed."""
        def copy(tensors):
            return [t.detach().clone() for t in tensors]
        adam = self.state.optimizer.adamw.state
        step = adam.get(self.params[0], {}).get("step", 0)
        self.late = {"params": copy(self.params), "ema": copy(self.ema),
                     "exp_avg": copy(self.moments("exp_avg")),
                     "exp_avg_sq": copy(self.moments("exp_avg_sq")),
                     "step": int(step), "gen": self.gen.get_state()}
        self.readings["late"] = self.steps(self.late["params"],
                                           self.late["ema"],
                                           self.late["exp_avg"])
        self.sync()
        del self.state, self.step_fn, self.params, self.ema

    # -- the check ---------------------------------------------------------
    def check(self, control: Optional[str] = None):
        """Both stages against the plain reference, fp32 with TF32 off: the
        start from the same weights, rows and draws; the late stage from the
        copy of the state the window reached (the window's own steps have no
        independent reference), with the same rows and draws.  Each step's
        loss (relative gap; after a stage's first step the two sides'
        parameters part where AdamW's lr-sized step takes a rounding-set
        sign, so its steps 2 and 3 read the noise of that parting), and by
        the worst leaf the gap of the norms of the first step's gradient, of
        the parameters' change and of the EMA's change after the third,
        each against the reference's norm of that leaf or of the median
        leaf, whichever is larger.  Leaves whose reference gradient is under
        a thousandth of the median leaf's move by round-off alone under
        AdamW and are left out of the two changes.  The late stage's
        numbers are named with "late_".  `control`: "fp8" (the reference
        with fp8 operands) or "half_batch" (the loss over half of the rows)
        in the program's place."""
        matmul, cudnn, tune = (torch.backends.cuda.matmul.allow_tf32,
                               torch.backends.cudnn.allow_tf32,
                               torch.backends.cudnn.benchmark)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True   # the reference's fp32 convs
        t0 = time.perf_counter()
        try:
            out = []
            for prefix, stage in (("", "start"), ("late_", "late")):
                ref = self.reference(stage, None)
                prog = (self.reference(stage, control) if control
                        else self.readings[stage])
                out += [(prefix + name, value)
                        for name, value in compare(prog, ref)]
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn
            torch.backends.cudnn.benchmark = tune
            print(f"reference: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr)

    def reference(self, stage: str, control: Optional[str]):
        """The reference's readings of `stage`: from the seeded weights and
        generator ("start"), or from the copy of the state the window
        reached ("late"), over the same rows; kept for a further check."""
        key = (stage, control)
        if key not in self.refs:
            self.refs[key] = self.follow(stage, control)
        return self.refs[key]

    def follow(self, stage: str, control: Optional[str]):
        cfg = self.cfg
        with torch.device(self.device):
            model = ru.unet_of(cfg)
        gen = torch.Generator(device=self.device)
        if stage == "start":
            p0 = weights.make(cfg, self.seed, self.device)
            gen.manual_seed(sub_seed(self.seed, "train"))
        else:
            p0 = dict(zip(self.readings["names"], self.late["params"]))
            gen.set_state(self.late["gen"])
        model.load_state_dict(p0)
        if control == "fp8":
            model.cast = ru.quantize_fp8
        state = rt.State(model)
        if state.names != self.readings["names"]:
            raise RuntimeError("the reference's leaves are not the port's")
        if stage == "late":
            late = self.late
            state.ema = [e.clone() for e in late["ema"]]
            state.m = [m.clone() for m in late["exp_avg"]]
            state.v = [v.clone() for v in late["exp_avg_sq"]]
            state.step = late["step"]
        e0 = [e.clone() for e in state.ema]
        s = rd.schedule(cfg, self.device)
        draws = rd.Draws(gen)
        out = {"loss": []}
        for k, at in enumerate(self.readings[stage]["rows"]):
            x0 = self.pool[at:at + self.b].to(self.device)
            step = rt.train_step(state, s, cfg, x0, draws,
                                 half_batch=control == "half_batch")
            out["loss"].append(float(step["loss"]))
            if k == 0:
                out["grad"] = leaf_norms(step["grads"])
            del step
        out["update"] = leaf_norms([p.detach() - p0[n] for n, p in
                                    zip(state.names, state.params)])
        out["ema"] = leaf_norms([e - b for e, b in zip(state.ema, e0)])
        return out


def compare(prog: Dict[str, object], ref: Dict[str, object]):
    """The numbers of one stage: each step's loss gap, and the worst
    leaf's gap of the gradient, the update and the EMA's change."""
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    g_ref = ref["grad"]
    moving = g_ref >= 1e-3 * float(np.median(g_ref))

    def worst(name, keep):
        r, p = ref[name][keep], prog[name][keep]
        floor = max(float(np.median(r)), 1e-30)
        return float(np.max(np.abs(p - r) / np.maximum(r, floor)))

    every = np.ones_like(moving)
    return [(f"loss_gap_step{k + 1}", v) for k, v in enumerate(loss_gaps)] + [
        ("grad_gap", worst("grad", every)),
        ("update_gap", worst("update", moving)),
        ("ema_gap", worst("ema", moving))]
