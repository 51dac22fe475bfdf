"""The detection entry: `detect.evaluate_anomaly_batch` on groups of
anomalous volumes, closed loop with one client.

The chain is built as `detect.anomalous_metric_calculation` builds it: the
UNet from `models.unet.unet_from_args`, the sampler from
`ops.noise.sampler_from_args`, `fb` = `diffusion.forward_backward` (DDPM)
or `forward_backward_ddim`.  Each group is a fresh `torch.Generator` on
the card, seeded from the run's seed and the group's index, and its host
arrays (images and masks, NHWC) are handed to the entry; the group's
latency runs from that hand-over to the return of its metrics.  The
benchmark's `fb` wrapper adds one synchronise after the chain's last
launch, where the entry's own copy to the host would wait anyway, so that
the host's enqueue time and the chain's end are both seen.

Traffic keys: sampler ("ddpm" | "ddim"), lambda, ddim_steps, ddim_eta,
volumes_per_group, slices_per_volume, pool_volumes (distinct volumes made
from the seed, taken in turn), warm_lambda and warm_steps (the warm-up's
short chain at the cell's shapes), check_groups (groups of the window
drawn from the seed for the check), check_slices (slices of each such
group that the reference recomputes: one drawn from the seed in each of
that many equal runs of the group's rows, so that every part of a batch
is looked at), and for `--trace 1` trace_groups (whole groups profiled) or
trace_steps (reverse steps profiled from the first of a group, where a
group is long).
"""

from __future__ import annotations

import random
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..reference import diffusion as rd
from ..reference import metrics as rm
from ..reference import unet as ru
from . import synthetic, trace, weights
from .seeds import sub_seed


def strata(pick: random.Random, n: int, k: int) -> List[int]:
    """One row drawn by `pick` from each of k equal runs of range(n)."""
    edges = [n * i // k for i in range(k + 1)]
    return [pick.randrange(lo, hi) for lo, hi in zip(edges, edges[1:])]


def sync_of(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


class Entry:
    def __init__(self, cell, run, seed: int, device):
        self.cell, self.run, self.seed, self.device = cell, run, seed, device
        self.cfg, self.tr = cell.cfg, cell.traffic
        self.sync = sync_of(device)
        self.checked: List[tuple] = []      # (group, recon, metrics)

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from anoddpm_torch import diffusion as dmod
        from anoddpm_torch.detect import evaluate_anomaly_batch
        from anoddpm_torch.models.unet import unet_from_args
        from anoddpm_torch.ops.noise import sampler_from_args
        from anoddpm_torch.schedule import schedule_from_args

        cfg, tr = self.cfg, self.tr
        with torch.device(self.device):
            model = unet_from_args(cfg, 1)
        model.load_state_dict(weights.make(cfg, self.seed, self.device))
        self.model = model.eval()
        self.sched = schedule_from_args(cfg).to(self.device)
        self.sampler = sampler_from_args(cfg)
        self.lam = min(int(tr["lambda"]), self.sched.num_timesteps)
        self.evaluate = evaluate_anomaly_batch
        em, sched, sampler = self.model, self.sched, self.sampler

        def chain(lam, steps):
            if tr["sampler"] == "ddim":
                eta = float(tr["ddim_eta"])
                return lambda x, g: dmod.forward_backward_ddim(
                    em, sched, x, lam, steps, g, noise_sampler=sampler, eta=eta)
            return lambda x, g: dmod.forward_backward(
                em, sched, x, lam, g, noise_sampler=sampler)

        self.fb = chain(self.lam, int(tr.get("ddim_steps", 0)))
        self.steps = (int(tr["ddim_steps"]) if tr["sampler"] == "ddim"
                      else self.lam)
        img = cfg["img_size"]
        self.hw = int(img[0] if isinstance(img, (list, tuple)) else img)
        spv = int(tr["slices_per_volume"])
        self.pool = [synthetic.anomalous_volume(self.seed, i, self.hw, self.hw,
                                                spv)
                     for i in range(int(tr["pool_volumes"]))]
        self.batch = int(tr["volumes_per_group"]) * spv
        warm = chain(int(tr.get("warm_lambda", self.lam)),
                     int(tr.get("warm_steps", 0)))
        images, masks = self.inputs(0)
        gen = torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, "warm"))
        self.evaluate(self.model, self.sched, images, masks, gen,
                      self.sampler, self.lam, fb=warm)
        self.sync()

    def inputs(self, g: int):
        vpg = int(self.tr["volumes_per_group"])
        vols = [self.pool[(g * vpg + i) % len(self.pool)] for i in range(vpg)]
        return (np.concatenate([v[0] for v in vols]),
                np.concatenate([v[1] for v in vols]))

    def generator(self, tag, g: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, tag, g))

    # -- one group ---------------------------------------------------------
    def group(self, tag: str, g: int, spans: bool):
        images, masks = self.inputs(g)
        t = {}

        def fb(x, gen):
            t0 = time.perf_counter()
            with trace.span("fb"):
                out = self.fb(x, gen)
            t1 = time.perf_counter()
            with trace.span("chain_end"):
                self.sync()
            t["enqueue"], t["chain"] = t1 - t0, time.perf_counter() - t0
            return out

        t0 = time.perf_counter()
        with trace.span("group"):
            out, recon = self.evaluate(self.model, self.sched, images, masks,
                                       self.generator(tag, g), self.sampler,
                                       self.lam, fb=fb)
        latency = time.perf_counter() - t0
        if spans:
            self.run.add("enqueue", t["enqueue"])
            self.run.add("entry_self", latency - t["chain"])
        return latency, out, recon

    # -- the traced window -------------------------------------------------
    def traced(self) -> None:
        window = trace.Window(self.sync)
        steps = int(self.tr.get("trace_steps", 0))
        if steps:
            count = [0]

            def hook(module, args):
                if count[0] == 0:
                    window.start("fb")
                elif count[0] == steps:
                    window.stop({"forwards": steps, "batch": self.batch})
                count[0] += 1

            handle = self.model.register_forward_pre_hook(hook)
            try:
                self.group("trace", 0, False)
            finally:
                handle.remove()
        else:
            groups = int(self.tr["trace_groups"])
            window.start()
            for g in range(groups):
                self.group("trace", g, False)
            window.stop({"forwards": groups * self.steps, "batch": self.batch})
        self.run.trace = window.summary

    # -- the measured window -----------------------------------------------
    def measure(self, seconds: float) -> None:
        keep = int(self.tr["check_groups"])
        pick = random.Random(sub_seed(self.seed, "check"))
        run = self.run
        run.window_start = start = time.perf_counter()
        g = 0
        while True:
            run.attempted += 1
            latency, out, recon = self.group("group", g, True)
            run.group_s.append(latency)
            run.units += recon.shape[0]
            # a uniform sample of `keep` groups, drawn from the seed
            item = (g, recon, out)
            if len(self.checked) < keep:
                self.checked.append(item)
            else:
                j = pick.randrange(g + 1)
                if j < keep:
                    self.checked[j] = item
            g += 1
            if time.perf_counter() - start >= seconds:
                break
        run.window_s = time.perf_counter() - start

    def release(self) -> None:
        del self.model, self.fb, self.sched, self.sampler

    # -- the check ---------------------------------------------------------
    def check(self, control: Optional[str] = None):
        """Each drawn group against the plain reference, fp32 with TF32 off,
        on the same images, weights and draws: `map_gap`, the relative RMS
        gap of the anomaly map (the square error) over `check_slices`
        slices of the group drawn from the seed; `metric_gap`, the largest
        gap between the seven metrics the entry returned for every slice
        and the reference's metrics of the entry's own reconstruction (the
        same float64 arithmetic: an exact comparison).  `control`: "fp8"
        puts the reference with fp8 operands in the program's place."""
        matmul, cudnn, tune = (torch.backends.cuda.matmul.allow_tf32,
                               torch.backends.cudnn.allow_tf32,
                               torch.backends.cudnn.benchmark)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True   # the reference's fp32 convs
        t0 = time.perf_counter()
        try:
            return self._check(control)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn
            torch.backends.cudnn.benchmark = tune
            print(f"reference: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr)

    def _check(self, control):
        cfg, tr = self.cfg, self.tr
        with torch.device(self.device):
            model = ru.unet_of(cfg)
        model.load_state_dict(weights.make(cfg, self.seed, self.device))
        model.eval()
        s = rd.schedule(cfg, self.device)
        lam = min(int(tr["lambda"]), s.T)
        pick = random.Random(sub_seed(self.seed, "rows"))

        def recon_of(images, g, rows, cast):
            model.cast = cast
            x0 = torch.from_numpy(np.ascontiguousarray(
                np.moveaxis(images[rows], -1, 1))).to(self.device)
            with torch.no_grad():
                x = rd.reconstruct(model, s, cfg, x0, lam,
                                   rd.Draws(self.generator("group", g)),
                                   tr["sampler"], int(tr.get("ddim_steps", 0)),
                                   float(tr.get("ddim_eta", 0.0)),
                                   batch=images.shape[0], rows=rows)
            return np.moveaxis(x.cpu().numpy(), 1, -1)

        map_gap = metric_gap = 0.0
        for g, recon, out in self.checked:
            images, masks = self.inputs(g)
            rows = strata(pick, images.shape[0], int(tr["check_slices"]))
            if recon.shape != images.shape or any(
                    len(out[k]) != images.shape[0] for k in rm.NAMES):
                return [("map_gap", float("inf")), ("metric_gap", float("inf"))]
            if control == "fp8":
                recon = recon.copy()
                recon[rows] = recon_of(images, g, rows, ru.quantize_fp8)
            ref = recon_of(images, g, rows, ru.identity)
            x0 = images[rows].astype(np.float64)
            e_prog = (x0 - recon[rows]) ** 2
            e_ref = (x0 - ref) ** 2
            map_gap = max(map_gap, float(np.linalg.norm(e_prog - e_ref)
                                         / np.linalg.norm(e_ref)))
            if control is None:
                want = rm.anomaly_metrics(images, recon, masks)
                metric_gap = max(metric_gap, max(
                    float(np.max(np.abs(np.asarray(out[k], np.float64) - want[k])))
                    for k in rm.NAMES))
        return [("map_gap", map_gap), ("metric_gap", metric_gap)]
