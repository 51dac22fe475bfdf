"""k2b_roofline.train: the bytes bound of every K2b call in the traced
window (x, the incoming gradient and dx once each, gamma, beta and their
gradients in fp32, the mean and rstd, at each site, from its shape), at
3.35 TB/s, over the summed device time of K2b's kernels (the backward and
its channel sums), in %.  Silent unless the trace holds one K2b backward
kernel per site and step.  Device trace."""

import re

from benchmark.core import yardstick as ys

MAIN = re.compile(r"group_norm_silu_bwd_kernel")


def read(run):
    tr = run.trace
    if tr is None or "steps" not in tr.units:
        return None
    seconds, _ = tr.seconds_of(ys.K2B_NAME)
    _, calls = tr.seconds_of(MAIN)
    steps = tr.units["steps"]
    if seconds <= 0 or calls != steps * ys.k2_sites(run.cfg):
        return None
    bound = (ys.k2b_bytes_per_step(run.cfg, tr.units["batch"]) * steps
             / ys.HBM_BYTES_PER_S)
    return bound / seconds * 100.0
